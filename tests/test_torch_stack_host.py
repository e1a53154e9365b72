"""The host stack of the full-stack apps, port against reference, on the CPU.

`srslte_tpu_torch` keeps its own copies of the 29 host modules that
`EnbApp` and `UeApp` import (security, NAS, RRC, RLC, PDCP, MAC, the
co-located core, the event log and the UE's NAS stack).  Each case below
drives the same seeded inputs through the JAX package's module and the
port's copy and holds every output equal: bytes, integers, decisions and
the fields of every dataclass, compared after `norm`.  One parametrised test
per family.  Then the port's analogs of tests/test_attach.py and of
tests/test_tft.py::test_ue_send_data_consults_tft.
"""

import dataclasses
import enum
import importlib
import os
import struct

import numpy as np
import pytest

from srslte_tpu_torch.epc import Hss, Mme, Spgw
from srslte_tpu_torch.gtpu import GtpuHeader, gtpu_pack, gtpu_unpack
from srslte_tpu_torch.security.milenage import compute_opc
from srslte_tpu_torch.ue_stack import SoftUsim, UeNas

IMSI = "001010123456789"
K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
PKGS = ("srslte_tpu", "srslte_tpu_torch")


def loader(pkg):
    return lambda name: importlib.import_module(f"{pkg}.{name}")


def norm(x):
    """A comparable form: dataclasses as (class name, fields), enums as
    ints, arrays as lists, event records without their wall-clock stamp."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,
                tuple((f.name, norm(getattr(x, f.name))) for f in dataclasses.fields(x)
                      if not f.name.startswith("_")))
    if isinstance(x, enum.Enum):
        return int(x.value)
    if isinstance(x, np.ndarray):
        return x.tolist()
    if isinstance(x, np.generic):
        return x.item()
    if isinstance(x, dict):
        return tuple(sorted((norm(k), norm(v)) for k, v in x.items()
                            if k != "timestamp"))
    if isinstance(x, (list, tuple)):
        return tuple(norm(v) for v in x)
    return x


def both(scenario, *args):
    """scenario(P, rng, *args) in both packages from the same seed."""
    out = [norm(scenario(loader(pkg), np.random.default_rng(7), *args)) for pkg in PKGS]
    assert out[0] == out[1]
    return out[1]


def rbytes(rng, n):
    return rng.integers(0, 256, n).astype(np.uint8).tobytes()


@pytest.fixture
def pinned_urandom(monkeypatch):
    """os.urandom as every module of both packages sees it, made a function
    of the request size (the HSS's RAND, a RACH identity given no CCCH SDU)."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) & 0xFF for i in range(n)))


# ---------------------------------------------------------------- security
def sc_aes(P, rng):
    aes = P("security.aes")
    out = []
    for n in (0, 1, 15, 16, 17, 64, 333):
        key, blk, ctr, msg = rbytes(rng, 16), rbytes(rng, 16), rbytes(rng, 16), rbytes(rng, n)
        out += [aes.aes128_encrypt_block(key, blk), aes.aes128_ctr(key, ctr, msg),
                aes.aes128_cmac(key, msg)]
    return out


def sc_snow3g(P, rng):
    s3g, c = P("security.snow3g"), P("security.ciphers")
    out = [s3g.Snow3G([int(w) for w in rng.integers(0, 2**32, 4)],
                      [int(w) for w in rng.integers(0, 2**32, 4)]).keystream(9)]
    for n in (1, 7, 16, 100, 257):
        key, data = rbytes(rng, 16), rbytes(rng, n)
        count, bearer, d = int(rng.integers(0, 2**32)), int(rng.integers(0, 32)), n % 2
        out += [s3g.eea1(key, count, bearer, d, data),
                s3g.eia1(key, count, int(rng.integers(0, 2**32)), d, data),
                c.cipher_encrypt(c.EEA1, key, count, bearer, d, data),
                c.integrity_mac(c.EIA1, key, count, bearer, d, data)]
    return out


def sc_zuc(P, rng):
    zuc, c = P("security.zuc"), P("security.ciphers")
    out = [zuc.Zuc(rbytes(rng, 16), rbytes(rng, 16)).keystream(9)]
    for n in (1, 7, 16, 100, 257):
        key, data = rbytes(rng, 16), rbytes(rng, n)
        count, bearer, d = int(rng.integers(0, 2**32)), int(rng.integers(0, 32)), n % 2
        out += [zuc.eea3(key, count, bearer, d, data), zuc.eia3(key, count, bearer, d, data),
                zuc.eia3(key, count, bearer, d, data, length_bits=8 * n - 3),
                c.cipher_encrypt(c.EEA3, key, count, bearer, d, data),
                c.integrity_mac(c.EIA3, key, count, bearer, d, data)]
    return out


def sc_ciphers(P, rng):
    c = P("security.ciphers")
    out = []
    for algo in (c.EEA0, c.EEA1, c.EEA2, c.EEA3):
        key, data = rbytes(rng, 16), rbytes(rng, 77)
        ct = c.cipher_encrypt(algo, key, 5, 3, 1, data)
        out += [ct, c.cipher_decrypt(algo, key, 5, 3, 1, ct) == data]
    for algo in (c.EIA1, c.EIA2, c.EIA3):
        out.append(c.integrity_mac(algo, rbytes(rng, 16), 9, 2, 0, rbytes(rng, 45)))
    return out


def sc_milenage(P, rng):
    m = P("security.milenage")
    out = []
    for _ in range(4):
        k, op, rand, sqn, amf = (rbytes(rng, 16), rbytes(rng, 16), rbytes(rng, 16),
                                 rbytes(rng, 6), rbytes(rng, 2))
        opc = m.compute_opc(k, op)
        out += [opc, m.milenage_f1(k, opc, rand, sqn, amf), m.milenage_f2345(k, opc, rand),
                m.milenage_f5_star(k, opc, rand)]
    return out


SECURITY = {"aes": sc_aes, "snow3g": sc_snow3g, "zuc": sc_zuc, "ciphers": sc_ciphers,
            "milenage": sc_milenage}


@pytest.mark.parametrize("name", SECURITY)
def test_security(name):
    both(SECURITY[name])


# --------------------------------------------------------------------- NAS
def sc_nas_keys(P, rng):
    k = P("nas.keys")
    out = []
    for ea, ia in ((0, 2), (1, 1), (2, 2), (3, 3)):
        ck, ik, sqn = rbytes(rng, 16), rbytes(rng, 16), rbytes(rng, 6)
        kasme = k.kdf_kasme(ck, ik, b"\x00\xf1\x10", sqn)
        kenb = k.kdf_kenb(kasme, int(rng.integers(0, 2**16)))
        out += [kasme, k.kdf_nas_keys(kasme, ea, ia), kenb, k.kdf_as_keys(kenb, ea, ia)]
    return out


def sc_nas_messages(P, rng):
    m = P("nas.messages")
    msgs = [m.AttachRequest(imsi=IMSI), m.AuthRequest(rand=rbytes(rng, 16), autn=rbytes(rng, 16)),
            m.AuthResponse(res=rbytes(rng, 8)), m.SecurityModeCommand(ea=2, ia=2),
            m.SecurityModeComplete(), m.AttachAccept(ip="172.16.0.2", guti=0x1234, teid_ul=0x77),
            m.AttachComplete(), m.TauRequest(update_type=1, guti=0xCAFE),
            m.TauAccept(update_result=0, guti=0xBEEF, tac=7), m.TauComplete()]
    out = []
    for ea, ia in ((1, 1), (2, 2), (3, 3)):
        k = rbytes(rng, 16)
        ue = m.NasSecurityContext(k_enc=k, k_int=k, ea=ea, ia=ia, direction=0)
        net = m.NasSecurityContext(k_enc=k, k_int=k, ea=ea, ia=ia, direction=1)
        for msg in msgs:
            plain = m.nas_pack(msg)
            prot = m.nas_pack(msg, sec_ctx=ue, new_ctx=isinstance(msg, m.SecurityModeComplete))
            out += [plain, m.nas_unpack(plain), prot, m.nas_unpack(prot, net)]
        sr = m.ServiceRequest(ksi=3).pack(ue)
        out += [sr, m.nas_unpack(sr, net)]
    return out


def ipv4(src="172.16.0.2", dst="8.8.8.8", proto=17, sport=5000, dport=53, tos=0):
    hdr = struct.pack("!BBHHHBBH4s4s", 0x45, tos, 28, 0, 0, 64, proto, 0,
                      bytes(map(int, src.split("."))), bytes(map(int, dst.split("."))))
    return hdr + struct.pack("!HHHH", sport, dport, 8, 0)


def sc_tft(P, rng):
    t = P("nas.tft")
    comps = [bytes([t.IPV4_REMOTE_ADDR, 8, 8, 8, 8, 255, 255, 255, 255,
                    t.SINGLE_REMOTE_PORT]) + struct.pack("!H", 53) + bytes([t.PROTOCOL_ID, 17]),
             bytes([t.IPV4_REMOTE_ADDR, 10, 0, 0, 0, 255, 0, 0, 0, t.LOCAL_PORT_RANGE])
             + struct.pack("!HH", 6000, 4000),
             bytes([t.TYPE_OF_SERVICE, 0xB8, 0xFC])]
    matcher = t.TftMatcher(default_lcid=3)
    out = []
    for i, comp in enumerate(comps):
        f = t.TftFilter.parse(5 + i, 4 + i, comp, eval_precedence=3 - i)
        matcher.add_filter(f)
        out.append(f)
    for _ in range(40):
        pkt = ipv4(dst=".".join(str(int(v)) for v in rng.choice([8, 10, 1], 1).tolist()
                                + rng.integers(0, 9, 3).tolist()),
                   proto=int(rng.choice([6, 17])), sport=int(rng.integers(3000, 7000)),
                   dport=int(rng.choice([53, 80])), tos=int(rng.choice([0, 0xB8])))
        out.append((matcher.check_match(pkt), [f.match(pkt) for f in matcher.filters]))
    matcher.remove_bearer(6)
    out.append(matcher.check_match(ipv4(src="172.16.0.2", dst="10.1.2.3", sport=5000)))
    return out


NAS = {"keys": sc_nas_keys, "messages": sc_nas_messages, "tft": sc_tft}


@pytest.mark.parametrize("name", NAS)
def test_nas(name):
    both(NAS[name])


# --------------------------------------------------------------------- RRC
def rrc_messages(P, rng):
    """Every RRC message the apps exchange, as (message, channel)."""
    r, sec = P("rrc.messages"), P("security")
    mci = r.MobilityControl(target_pci=7, new_crnti=0x150, t304_ms=200, ra_preamble=60)
    return [
        (r.ConnectionRequest(ue_identity=rbytes(rng, 5)), "ul_ccch"),
        (r.ConnectionSetup(), "dl_ccch"),
        (r.ConnectionSetupComplete(nas_pdu=rbytes(rng, 23)), "ul_dcch"),
        (r.DlInformationTransfer(nas_pdu=rbytes(rng, 40)), "dl_dcch"),
        (r.UlInformationTransfer(nas_pdu=rbytes(rng, 11)), "ul_dcch"),
        (r.RrcSecurityModeCommand(sec.EEA2, sec.EIA2), "dl_dcch"),
        (r.RrcSecurityModeComplete(), "ul_dcch"),
        (r.ConnectionReconfiguration(drb_id=1, nas_pdu=rbytes(rng, 30),
                                     meas=r.MeasConfigA3(a3_offset_db=3.0)), "dl_dcch"),
        (r.ConnectionReconfiguration(drb_id=0, mobility=mci), "dl_dcch"),
        (r.ConnectionReconfiguration(drb_id=1), "dl_dcch"),
        (r.ConnectionReconfigurationComplete(), "ul_dcch"),
        (r.MeasurementReportMsg(meas_id=1, serving_rsrp_dbm=-97.0,
                                neighbors={7: -90.0, 9: -101.0}), "ul_dcch"),
        (r.ReestablishmentRequest(c_rnti=0x46, pci=42, short_mac_i=0xBEEF,
                                  cause="other_fail"), "ul_ccch"),
        (r.Reestablishment(), "dl_ccch"),
        (r.ReestablishmentReject(), "dl_ccch"),
        (r.ReestablishmentComplete(), "ul_dcch"),
        (r.Sib1(), "bcch"),
        (r.Sib2(), "bcch"),
        (r.Sib2(root_seq_idx=22, prach_cfg_idx=4, zero_corr_cfg=5, prach_freq_offset=3,
                n1_pucch_an=20), "bcch"),
        (r.Paging(records=(0x1234, 0xCAFE01)), "pcch"),
        (r.ConnectionRelease(), "dl_dcch"),
    ]


def sc_rrc_pack(P, rng):
    r = P("rrc.messages")
    return [(r.rrc_pack(m), r.rrc_unpack(r.rrc_pack(m), ch)) for m, ch in rrc_messages(P, rng)]


def sc_per(P, rng):
    per = P("rrc.per")
    w = per.BitWriter()
    widths = rng.integers(1, 33, 50).tolist()
    vals = [int(rng.integers(0, 2**wd)) for wd in widths]
    for v, wd in zip(vals, widths):
        w.put(v, wd)
    raw = w.to_bytes()
    rd = per.BitReader(raw)
    return [raw, [rd.get(wd) for wd in widths]]


def sc_sib2_prach(P, rng):
    r, params = P("rrc.messages"), P("phy.common.params")
    out = []
    for idx in (3, 4, 5):
        s = r.Sib2(prach_cfg_idx=idx, zero_corr_cfg=int(rng.integers(1, 15)))
        cfg = s.prach_config(params.Cell(n_prb=6, id=1).ofdm)
        out += [s.prach_sf, cfg.n_cs, cfg.preamble_table]
    return out


def sc_meas_mobility(P, rng):
    meas, mob, sec = P("rrc.meas"), P("rrc.mobility"), P("security")
    eng = meas.MeasEventEngine(1, meas.ReportConfig(event="a3", a3_offset_db=3.0,
                                                    hysteresis_db=1.0, time_to_trigger_ms=10))
    out = []
    for _ in range(60):
        serving = float(rng.normal(-95, 3))
        out.append(eng.tick(serving, {7: float(rng.normal(-93, 4)),
                                      9: float(rng.normal(-99, 4))}, 5))
    rlm = mob.RadioLinkMonitor(mob.RlmConfig())
    out.append([rlm.step(float(v)) for v in rng.normal(-1, 4, 80)])
    out += [mob.short_mac_i(rbytes(rng, 16), ia, 0x1A2B3C, 42, 0x46)
            for ia in (sec.EIA1, sec.EIA2, sec.EIA3)]
    return out


RRC = {"rrc_pack": sc_rrc_pack, "per": sc_per, "sib2_prach": sc_sib2_prach,
       "meas_mobility": sc_meas_mobility}


@pytest.mark.parametrize("name", RRC)
def test_rrc(name):
    both(RRC[name])


# --------------------------------------------------------------------- RLC
def rlc_link(P, rng, kind, loss):
    """SDUs of seeded sizes through a tx and an rx entity with grants of
    seeded sizes, a seeded share of PDUs lost (each way), and ticks."""
    rlc = P("rlc")
    tx, rx = {"tm": (rlc.RlcTm, rlc.RlcTm), "um": (rlc.RlcUm, rlc.RlcUm),
              "am": (rlc.RlcAm, rlc.RlcAm)}[kind]
    tx, rx = tx(), rx()
    sdus = [rbytes(rng, int(n)) for n in rng.integers(1, 300, 30)]
    log = []
    for step in range(400):
        if sdus and step % 3 == 0:
            tx.write_sdu(sdus.pop(0))
        log.append(tx.get_buffer_state())
        pdu = tx.read_pdu(int(rng.integers(8, 200)))
        log.append(pdu)
        if pdu is not None and rng.random() >= loss:
            rx.write_pdu(pdu)
        if kind == "am":
            st = rx.read_pdu(int(rng.integers(8, 64)))
            log.append(st)
            if st is not None and rng.random() >= loss:
                tx.write_pdu(st)
            tx.tick()
            rx.tick()
    return log, list(rx.rx_sdus)


def sc_rlc_bits(P, rng):
    b = P("rlc.bits")
    w = b.BitWriter()
    widths = rng.integers(1, 17, 40).tolist()
    vals = [int(rng.integers(0, 2**wd)) for wd in widths]
    for v, wd in zip(vals, widths):
        w.put(v, wd)
    raw = w.to_bytes()
    rd = b.BitReader(raw)
    got = [rd.get(wd) for wd in widths]
    rd.align()
    return [raw, got, rd.rest()]


def sc_rlc_am_codec(P, rng):
    am = P("rlc.am")
    nacks = sorted(set(rng.integers(0, 1000, 6).tolist()))
    st = am.pack_status(1001, nacks)
    pdu = am.AmdPdu(sn=517, fi=1, poll=True, segments=[rbytes(rng, 40), rbytes(rng, 9)])
    return [st, am.unpack_status(st), am.pack_amd(pdu), am.unpack_amd(am.pack_amd(pdu)),
            am.is_control(st)]


RLC = {"tm": ("tm", 0.0), "um": ("um", 0.1), "am": ("am", 0.15), "am_clean": ("am", 0.0)}


@pytest.mark.parametrize("name", RLC)
def test_rlc_link(name):
    log, got = both(rlc_link, *RLC[name])
    if RLC[name][0] == "am":
        assert len(got) == 30  # every SDU delivered, the losses recovered


@pytest.mark.parametrize("name", ["bits", "am_codec"])
def test_rlc_codec(name):
    both({"bits": sc_rlc_bits, "am_codec": sc_rlc_am_codec}[name])


# -------------------------------------------------------------------- PDCP
@pytest.mark.parametrize("srb,ea,ia", [(True, 2, 2), (True, 1, 1), (True, 3, 3),
                                       (False, 2, 0), (False, 0, 0), (False, 3, 0)])
def test_pdcp(srb, ea, ia):
    def sc(P, rng):
        pd = P("pdcp")
        cfg = pd.PdcpConfig(is_srb=srb, bearer_id=1, ea=ea, ia=ia)
        k1, k2 = rbytes(rng, 16), rbytes(rng, 16)
        ue, enb = pd.PdcpEntity(cfg, k1, k2, is_ue=True), pd.PdcpEntity(cfg, k1, k2, is_ue=False)
        out = []
        for n in rng.integers(1, 200, 12):
            sdu = rbytes(rng, int(n))
            up, down = ue.tx(sdu), enb.tx(sdu)
            out += [up, enb.rx(up), down, ue.rx(down)]
        bad = bytearray(ue.tx(b"tampered"))
        bad[-1] ^= 1
        out += [enb.rx(bytes(bad)), enb.integrity_failed]
        return out
    both(sc)


# --------------------------------------------------------------------- MAC
def sc_mac_pdu(P, rng):
    pdu_m, proc = P("mac.pdu"), P("mac.proc")
    out = []
    for ul in (False, True):
        for _ in range(6):
            pdu = pdu_m.MacPdu(ul=ul)
            if ul:
                pdu.add_ce(int(pdu_m.UL_LCID.SHORT_BSR),
                           proc.short_bsr_ce(0, int(rng.integers(0, 200000))))
            else:
                pdu.add_ce(int(pdu_m.DL_LCID.CON_RES_ID), rbytes(rng, 6))
            for lcid in (1, 3):
                pdu.add_sdu(lcid, rbytes(rng, int(rng.integers(1, 400))))
            raw = pdu.pack(pdu_len=len(pdu.pack()) + int(rng.choice([0, 1, 6, 12, 30])))
            out += [raw, pdu_m.MacPdu.parse(raw, ul=ul)]
    return out


def sc_mac_rar(P, rng):
    pdu_m = P("mac.pdu")
    out = []
    for backoff in (None, 3):
        rar = pdu_m.RarPdu(backoff=backoff)
        for _ in range(3):
            rar.rars.append(pdu_m.Rar(rapid=int(rng.integers(0, 64)),
                                      ta=int(rng.integers(0, 2048)),
                                      grant=int(rng.integers(0, 2**20)),
                                      temp_crnti=int(rng.integers(0x46, 0xFFF0))))
        out += [rar.pack(), pdu_m.RarPdu.parse(rar.pack())]
    return out


def sc_mac_bsr(P, rng):
    proc = P("mac.proc")
    nbytes = rng.integers(0, 200000, 40).tolist()
    out = [[proc.bsr_index(n) for n in nbytes], [proc.bsr_bytes(i) for i in range(64)],
           [proc.short_bsr_ce(int(rng.integers(0, 4)), n) for n in nbytes[:8]],
           proc.long_bsr_ce(nbytes[:4]), proc.parse_long_bsr(proc.long_bsr_ce(nbytes[:4])),
           [proc.phr_ce(p) for p in (-23.0, 0.0, 12.5, 40.0)],
           [proc.parse_phr(proc.phr_ce(p)) for p in (-23.0, 0.0, 12.5, 40.0)]]
    bsr, sr = proc.BsrProc(), proc.SrProc()
    for n in nbytes:
        bsr.buffer_state_changed(n)
        bsr.tick()
        out.append(bsr.generate({0: n}))
        if n % 3 == 0:
            sr.trigger()
        out.append(sr.sr_opportunity())
        if n % 5 == 0:
            sr.grant_received()
    return out


def sc_mac_ra(P, rng):
    ra, pdu_m = P("mac.ra"), P("mac.pdu")
    enb, ue = ra.EnbRach(), ra.UeRaProc()
    out = []
    for attempt in range(3):
        p = ue.start(np.random.default_rng(attempt))
        out.append(p)
        ccch = rbytes(rng, 6)
        rar = enb.rach_detected([p, (p + 5) % 64], [int(rng.integers(0, 100)), 3])
        msg3 = ue.rx_rar(rar, ccch_sdu=ccch if attempt != 1 else None)
        out += [rar, msg3 and msg3.pack()]
        msg4 = enb.rx_msg3(ue.temp_crnti, msg3.pack()) if msg3 else None
        out += [msg4, msg4 is not None and ue.rx_msg4(msg4), ue.state]
        for _ in range(5):
            ue.tick()
    enb.reserve(60, 0x200)
    out.append(ue.start_dedicated(60))
    out.append(ue.rx_rar_dedicated(enb.rach_detected([60], [4])))
    return out


MAC = {"pdu": sc_mac_pdu, "rar": sc_mac_rar, "bsr": sc_mac_bsr, "ra": sc_mac_ra}


@pytest.mark.parametrize("name", MAC)
def test_mac(name, pinned_urandom):
    both(MAC[name])


# --------------------------------------------------------------- schedulers
def sc_sched(P, rng, n_prb):
    sched, params, harq = P("mac.sched"), P("phy.common.params"), P("mac.harq")
    cell = params.Cell(n_prb=n_prb, id=42, nof_ports=1)
    dl, ul = sched.SchedDl(cell, cfi=2), sched.SchedUl(cell, cfi=2)
    rntis = (0x46, 0x47, 0x48)
    for r in rntis:
        dl.add_ue(r)
    out = [harq.RV_SEQ]
    for tti in range(200):
        for r in rntis:
            if rng.random() < 0.5:
                dl.buffer_state(r, int(rng.integers(0, 20000)))
            if rng.random() < 0.3:
                ul.ul_bsr(r, int(rng.integers(0, 20000)))
        if rng.random() < 0.2:
            dl.ues[rntis[int(rng.integers(0, 3))]].cqi = int(rng.integers(1, 16))
        bc = [(0xFFFF, int(rng.integers(10, 40)), 0)] if tti % 20 == 5 else []
        if tti % 10 == 7:
            bc.append((0x0002, 7, 0))
        bc_allocs, dl_allocs = dl.schedule_sf(tti, bc)
        dl.check_invariants(dl_allocs)
        used = np.zeros(P("phy.phch.regs").reg_layout(cell).n_cce[2], bool)
        for a in bc_allocs + dl_allocs:
            used[a.loc.cce: a.loc.cce + a.loc.L] = True
        ul_allocs = ul.schedule(tti, used_cce=used)
        ul.check_invariants(ul_allocs)
        out += [bc_allocs, dl_allocs, ul_allocs]
    return out


@pytest.mark.parametrize("n_prb", [6, 100])
def test_schedulers(n_prb):
    out = both(sc_sched, n_prb)
    assert sum(len(a) for a in out[2::3]) > 0 and sum(len(a) for a in out[3::3]) > 0


# -------------------------------------------------- core network and attach
def run_attach(P, ue_id=1):
    epc, us, mil = P("epc"), P("ue_stack"), P("security.milenage")
    hss = epc.Hss()
    hss.add_subscriber(IMSI, K, op=OP)
    spgw = epc.Spgw()
    mme = epc.Mme(hss, spgw)
    ue = us.UeNas(us.SoftUsim(IMSI, K, mil.compute_opc(K, OP)))
    log = []
    ul = [ue.start_attach()]
    for _ in range(10):
        log.append(ul)
        dl = [d for pdu in ul for d in mme.rx_nas(ue_id, pdu)]
        log.append(dl)
        if not dl:
            break
        ul = [u for pdu in dl for u in ue.rx_nas(pdu)]
    return ue, mme, spgw, log


def sc_attach(P, rng):
    g = P("gtpu")
    ue, mme, spgw, log = run_attach(P)
    ctx = mme.ues[1]
    gpdu = g.gtpu_pack(g.GtpuHeader(teid=ue.teid_ul), b"ping")
    return [log, ue.state, ue.ip, ue.guti, ue.sec, ue.kasme, ctx.state, ctx.sec, ctx.kasme,
            ctx.teid_dl, gpdu, g.gtpu_unpack(gpdu), spgw.rx_s1u(gpdu),
            spgw.tx_sgi(ue.ip, b"pong")]


def sc_events(P, rng):
    ev = P("utils.events").EventLog(keep=4)
    ev.sector_start(0, 42, 42)
    ev.rrc_event(0, 0x46, "connected")
    ev.measurement_report(0, 0x46)
    ev.rlf(0, 0x46)
    ev.rrc_event(0, 0x46, "released")
    return [ev.events, ev.of_kind("rrc_released")]


@pytest.mark.parametrize("name", ["attach", "events"])
def test_core(name, pinned_urandom):
    both({"attach": sc_attach, "events": sc_events}[name])


# ------------------------------- the port's analogs of tests/test_attach.py
def _make_network():
    hss = Hss()
    hss.add_subscriber(IMSI, K, op=OP)
    spgw = Spgw()
    mme = Mme(hss, spgw)
    ue = UeNas(SoftUsim(IMSI, K, compute_opc(K, OP)))
    return ue, mme, spgw


def _run_attach(ue, mme, ue_id=1):
    ul = [ue.start_attach()]
    for _ in range(10):
        dl = []
        for pdu in ul:
            dl.extend(mme.rx_nas(ue_id, pdu))
        if not dl:
            break
        ul = []
        for pdu in dl:
            ul.extend(ue.rx_nas(pdu))
    return ue, mme


def test_attach_establishes_security_and_ip():
    ue, mme, spgw = _make_network()
    _run_attach(ue, mme)
    assert ue.state == "attached"
    assert ue.ip.startswith("172.16.0.")
    ctx = mme.ues[1]
    assert ctx.state == "attached"
    assert ue.sec.k_int == ctx.sec.k_int
    assert ue.sec.k_enc == ctx.sec.k_enc
    assert ue.ip == spgw.by_ue_ip[ue.ip].ue_ip


def test_attach_unknown_imsi_rejected():
    ue, mme, _ = _make_network()
    ue.usim.imsi = "999999999999999"
    assert mme.rx_nas(2, ue.start_attach()) == []


def test_attach_wrong_key_fails_auth():
    ue, mme, _ = _make_network()
    ue.usim.key = bytes(16)
    dl = mme.rx_nas(3, ue.start_attach())
    with pytest.raises(ValueError, match="AUTN MAC"):
        ue.rx_nas(dl[0])


def test_user_plane_through_spgw():
    ue, mme, spgw = _make_network()
    _run_attach(ue, mme)
    sgi_out = []
    spgw.sgi_tx = lambda ip, pkt: sgi_out.append((ip, pkt))
    pkt = b"ping-request-payload"
    got = spgw.rx_s1u(gtpu_pack(GtpuHeader(teid=ue.teid_ul), pkt))
    assert got == (ue.ip, pkt)
    assert sgi_out == [(ue.ip, pkt)]
    hdr, payload = gtpu_unpack(spgw.tx_sgi(ue.ip, b"ping-reply"))
    assert payload == b"ping-reply"
    assert hdr.teid == mme.ues[1].teid_dl


def test_user_plane_over_pdcp_rlc():
    from srslte_tpu_torch.pdcp import PdcpConfig, PdcpEntity
    from srslte_tpu_torch.rlc import RlcAm
    from srslte_tpu_torch.security import EEA2

    ue, mme, spgw = _make_network()
    _run_attach(ue, mme)
    cfg = PdcpConfig(is_srb=False, bearer_id=1, ea=EEA2)
    ue_pdcp = PdcpEntity(cfg, ue.sec.k_enc, is_ue=True)
    enb_pdcp = PdcpEntity(cfg, ue.sec.k_enc, is_ue=False)
    ue_rlc, enb_rlc = RlcAm(), RlcAm()
    packets = [bytes([i]) * (20 + i) for i in range(8)]
    for p in packets:
        ue_rlc.write_sdu(ue_pdcp.tx(p))
    while (pdu := ue_rlc.read_pdu(120)) is not None:
        enb_rlc.write_pdu(pdu)
    received = []
    for rlc_sdu in enb_rlc.rx_sdus:
        ip_pkt = enb_pdcp.rx(rlc_sdu)
        received.append(spgw.rx_s1u(gtpu_pack(GtpuHeader(teid=ue.teid_ul), ip_pkt))[1])
    assert received == packets


def test_nas_service_request_short_mac():
    from srslte_tpu_torch.nas.messages import NasSecurityContext, ServiceRequest, nas_unpack

    k = bytes(range(16))
    ue = NasSecurityContext(k_enc=k, k_int=k, ea=1, ia=1, direction=0, tx_count=5)
    mme = NasSecurityContext(k_enc=k, k_int=k, ea=1, ia=1, direction=1, rx_count=5)
    raw = ServiceRequest(ksi=3).pack(ue)
    assert len(raw) == 4
    msg, protected = nas_unpack(raw, mme)
    assert protected and isinstance(msg, ServiceRequest) and msg.ksi == 3
    assert mme.rx_count == 6
    bad = raw[:3] + bytes([raw[3] ^ 0xFF])
    with pytest.raises(ValueError):
        nas_unpack(bad, NasSecurityContext(k_enc=k, k_int=k, ea=1, ia=1, direction=1,
                                           rx_count=5))


def test_nas_tau_flow_protected():
    from srslte_tpu_torch.nas.messages import (NasSecurityContext, TauAccept, TauComplete,
                                               TauRequest, nas_pack, nas_unpack)

    k = bytes(range(16, 32))
    ue = NasSecurityContext(k_enc=k, k_int=k, ea=2, ia=2, direction=0)
    mme = NasSecurityContext(k_enc=k, k_int=k, ea=2, ia=2, direction=1)
    msg, prot = nas_unpack(nas_pack(TauRequest(update_type=2, guti=0xCAFE01), sec_ctx=ue), mme)
    assert prot and isinstance(msg, TauRequest)
    assert msg.update_type == 2 and msg.guti == 0xCAFE01
    acc, _ = nas_unpack(nas_pack(TauAccept(update_result=0, guti=0xBEEF02, tac=0x1234),
                                 sec_ctx=mme), ue)
    assert acc.guti == 0xBEEF02 and acc.tac == 0x1234
    assert isinstance(nas_unpack(nas_pack(TauComplete(), sec_ctx=ue), mme)[0], TauComplete)


# ------------------- the port's analog of test_tft's UE uplink through the TFT
def test_ue_send_data_consults_tft(monkeypatch):
    from srslte_tpu_torch.nas.tft import SINGLE_REMOTE_PORT, TftFilter
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.ue import UeApp

    ue = UeApp(Cell(n_prb=15, id=1, nof_ports=1),
               UeNas(SoftUsim(IMSI, bytes(16), bytes(16))), device="cpu")

    class FakeBearer:
        def __init__(self):
            self.sdus = []

        def write_sdu(self, sdu):
            self.sdus.append(sdu)

    class FakePdcp:
        def tx(self, pkt):
            return pkt

    default, dedicated = FakeBearer(), FakeBearer()
    ue.drb1, ue.pdcp_drb = default, FakePdcp()
    monkeypatch.setattr(UeApp, "bearers", property(
        lambda self: {3: (self.drb1, self.pdcp_drb), 4: (dedicated, FakePdcp())}))
    ue.tft.add_filter(TftFilter.parse(6, 4, bytes([SINGLE_REMOTE_PORT]) + (53).to_bytes(2, "big"),
                                      eval_precedence=1))
    ue.send_data(ipv4(dport=53))
    ue.send_data(ipv4(dport=80))
    assert len(dedicated.sdus) == 1
    assert len(default.sdus) == 1
