"""NR stack parity: the port's MAC/RLC/PDCP-NR, HARQ-NR, slot workers, NR
stack and VNF split against the JAX package, on the CPU.

Analogs of tests/test_nr_l2.py (UM-NR, AM-NR, PDCP-NR, MAC-NR), of the
HARQ-NR entity tests of tests/test_nr_worker.py, of tests/test_vnf.py and of
tests/test_nr_stack.py.  The host codecs get the same numpy-seeded bytes in
both packages and must give the same bytes.  The device work (the HARQ soft
buffers, the workers' slots) runs on the same inputs in both packages: soft
buffers within 1e-5 of their largest magnitude (the port's rate recovery is
an `index_add_`, the reference's a scatter-add), slot grids within 1e-5 of
their largest magnitude, and DCI, ACK bits, delivered bits and packets
equal.  The JAX halves stay small: the workers on a 24 PRB carrier, all
slots at slot number 0 so that each JAX function compiles once, and three
slots in lockstep (not the JAX package's 24-slot loop).
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.mac.harq_nr as j_harq
import srslte_tpu.mac.pdu_nr as j_pdu
import srslte_tpu.nr_stack as j_stack
import srslte_tpu.nr_worker as j_worker
import srslte_tpu.pdcp.entity_nr as j_pdcp
import srslte_tpu.phy.nr as J
import srslte_tpu.rlc as j_rlc
import srslte_tpu.rlc.am_nr as j_am
import srslte_tpu.rlc.um_nr as j_um
import srslte_tpu.vnf as j_vnf
import srslte_tpu_torch.mac.harq_nr as t_harq
import srslte_tpu_torch.mac.pdu_nr as t_pdu
import srslte_tpu_torch.nr_stack as t_stack
import srslte_tpu_torch.nr_worker as t_worker
import srslte_tpu_torch.pdcp.entity_nr as t_pdcp
import srslte_tpu_torch.phy.nr as T
import srslte_tpu_torch.rlc as t_rlc
import srslte_tpu_torch.rlc.am_nr as t_am
import srslte_tpu_torch.rlc.um_nr as t_um
import srslte_tpu_torch.vnf as t_vnf
from srslte_tpu.phy.nr import dlsch_nr as j_dlsch
from srslte_tpu_torch.phy.nr import dlsch_nr as t_dlsch

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores
KEY = bytes(range(16))


@pytest.fixture(autouse=True)
def _fresh_xla_executables():
    """XLA on the CPU keeps every executable it compiles mapped into the
    process, and one eager slot of the JAX package's NR receiver adds about
    5,400 mappings: a test worker that passes the kernel's 65,530 dies in
    LLVM ("Cannot allocate memory").  Each test here starts and ends with
    the compilation caches dropped, so it neither meets a nearly full map
    nor leaves one to the worker's next test."""
    jax.clear_caches()
    yield
    jax.clear_caches()


def rand_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


# ------------------------------------------------------------------ RLC UM-NR
@pytest.mark.parametrize("sn_bits", [6, 12])
def test_um_nr_header_codec(sn_bits):
    rng = np.random.default_rng(sn_bits)
    for si in (j_um.SI_FULL, j_um.SI_FIRST, j_um.SI_MID, j_um.SI_LAST):
        for _ in range(8):
            sn, so = int(rng.integers(0, 1 << sn_bits)), int(rng.integers(0, 1 << 16))
            payload = rand_bytes(rng, int(rng.integers(0, 40)))
            raw = j_um.pack_um_nr(si, sn, so, payload, sn_bits)
            assert t_um.pack_um_nr(si, sn, so, payload, sn_bits) == raw
            assert t_um.unpack_um_nr(raw, sn_bits) == j_um.unpack_um_nr(raw, sn_bits)


@pytest.mark.parametrize("sn_bits,grant", [(6, 90), (12, 90), (12, 37)])
def test_um_nr_segmentation_roundtrip(sn_bits, grant):
    rng = np.random.default_rng(grant)
    sdus = [rand_bytes(rng, n) for n in (10, 300, 77, 1200, 5)]
    out = []
    for m in (j_um, t_um):
        tx, rx = m.RlcUmNr(sn_bits=sn_bits), m.RlcUmNr(sn_bits=sn_bits)
        for s in sdus:
            tx.write_sdu(s)
        pdus = []
        while tx.get_buffer_state() and (p := tx.read_pdu(grant)) is not None:
            pdus.append(p)
        for p in pdus:
            rx.write_pdu(p)
        out.append((pdus, rx.rx_sdus))
    assert out[0] == out[1]
    assert out[1][1] == sdus


def test_um_nr_out_of_order_and_timer():
    for m in (j_um, t_um):
        tx, rx = m.RlcUmNr(), m.RlcUmNr()
        tx.write_sdu(bytes(range(250)))
        pdus = []
        while (p := tx.read_pdu(60)) is not None:
            pdus.append(p)
        for p in reversed(pdus):
            rx.write_pdu(p)
        assert rx.rx_sdus == [bytes(range(250))]
        tx, rx = m.RlcUmNr(t_reassembly=2), m.RlcUmNr(t_reassembly=2)
        tx.write_sdu(bytes(100))
        p1, _, p3 = tx.read_pdu(40), tx.read_pdu(40), tx.read_pdu(200)
        rx.write_pdu(p1)
        rx.write_pdu(p3)
        for _ in range(3):
            rx.tick()
        assert rx.rx_sdus == [] and not rx._rx_segs


# ------------------------------------------------------------------ RLC AM-NR
@pytest.mark.parametrize("sn_bits", [12, 18])
def test_am_nr_data_headers(sn_bits):
    rng = np.random.default_rng(sn_bits)
    for _ in range(32):
        fields = dict(sn=int(rng.integers(0, 1 << sn_bits)), si=int(rng.integers(0, 4)),
                      p=int(rng.integers(0, 2)), so=int(rng.integers(0, 1 << 16)))
        if fields["si"] in (j_am.SI_FULL, j_am.SI_FIRST):
            fields["so"] = 0
        payload = rand_bytes(rng, 5)
        raw = j_am.pack_am_nr(j_am.AmNrHeader(**fields), payload, sn_bits)
        assert t_am.pack_am_nr(t_am.AmNrHeader(**fields), payload, sn_bits) == raw
        jh, jp = j_am.unpack_am_nr(raw, sn_bits)
        th, tp = t_am.unpack_am_nr(raw, sn_bits)
        assert vars(jh) == vars(th) and jp == tp
        assert j_am.is_control_pdu(raw) == t_am.is_control_pdu(raw)
    # malformed 18-bit header (reserved bits), and the 12-bit reference vector
    assert t_am.unpack_am_nr(bytes([0xB7, 0x00, 0xFF, 0x02, 0x02]), 18) is None
    tv = bytes([0xA4, 0x04, 0x04, 0x04, 0x11])
    assert t_am.pack_am_nr(*t_am.unpack_am_nr(tv, 12), 12) == tv


def test_am_nr_status():
    rng = np.random.default_rng(7)
    for n in (0, 1, 2, 5):
        ack = int(rng.integers(0, 4096))
        nacks = [int(v) for v in rng.integers(0, 4096, n)]
        raw = j_am.pack_am_nr_status(j_am.AmNrStatus(ack, list(nacks)), 12)
        assert t_am.pack_am_nr_status(t_am.AmNrStatus(ack, list(nacks)), 12) == raw
        got = t_am.unpack_am_nr_status(raw, 12)
        assert (got.ack_sn, got.nacks) == (ack, nacks)
    for bad in (bytes([0x08, 0x11, 0x40]), bytes([0x80, 0x00])):
        assert t_am.unpack_am_nr_status(bad, 12) is None
    assert t_am.pack_am_nr_status(t_am.AmNrStatus(70000), 18) == \
        j_am.pack_am_nr_status(j_am.AmNrStatus(70000), 18)


def test_rlc_package_exports_the_nr_names():
    names = ("AmNrHeader", "AmNrStatus", "is_control_pdu", "pack_am_nr", "pack_am_nr_status",
             "unpack_am_nr", "unpack_am_nr_status", "RlcAm", "RlcTm", "RlcUm")
    for n in names:
        assert hasattr(j_rlc, n) and hasattr(t_rlc, n), n


# ------------------------------------------------------------------ PDCP-NR
@pytest.mark.parametrize("sn_bits,srb,cipher,integrity", [
    (12, False, False, False), (18, False, False, False), (12, False, True, False),
    (12, True, True, True), (18, True, False, True)])
def test_pdcp_nr_bytes(sn_bits, srb, cipher, integrity):
    rng = np.random.default_rng(sn_bits + 2 * srb + 4 * cipher)
    kw = dict(sn_bits=sn_bits, is_srb=srb, k_enc=KEY if cipher else None,
              k_int=KEY[::-1] if integrity else None)
    ja, jb, ta, tb = (j_pdcp.PdcpEntityNr(**kw), j_pdcp.PdcpEntityNr(**kw),
                      t_pdcp.PdcpEntityNr(**kw), t_pdcp.PdcpEntityNr(**kw))
    for ent in (ja, jb, ta, tb):  # start near the SN wrap: COUNT inference
        ent.tx_next = ent.rx_next = (1 << sn_bits) - 3
    for _ in range(6):
        sdu = rand_bytes(rng, int(rng.integers(1, 200)))
        pdu = ja.tx(sdu)
        assert ta.tx(sdu) == pdu
        assert jb.rx(pdu) == tb.rx(pdu) == sdu
    assert ta.tx_next == ja.tx_next and tb.rx_next == jb.rx_next == (1 << sn_bits) + 3
    if integrity:
        bad = pdu[:-1] + bytes([pdu[-1] ^ 1])
        assert jb.rx(bad) is None and tb.rx(bad) is None
        assert tb.integrity_failures == jb.integrity_failures == 1


# ------------------------------------------------------------------ MAC-NR
@pytest.mark.parametrize("is_ul", [False, True])
def test_mac_pdu_nr_bytes(is_ul):
    rng = np.random.default_rng(int(is_ul))
    for trial in range(6):
        pdus = [m.MacPduNr(is_ul=is_ul) for m in (j_pdu, t_pdu)]
        ces = ((t_pdu.LCID_SHORT_BSR, 1), (t_pdu.LCID_C_RNTI, 2)) if is_ul else \
              ((t_pdu.LCID_CON_RES, 6), (t_pdu.LCID_TA_CMD, 1))
        items = [("sdu", int(rng.integers(1, 33)), rand_bytes(rng, int(rng.choice([3, 200, 300]))))
                 for _ in range(int(rng.integers(1, 4)))]
        items += [("ce", lcid, rand_bytes(rng, n)) for lcid, n in ces[: trial % 3]]
        for pdu in pdus:
            for kind, lcid, payload in items:
                (pdu.add_sdu if kind == "sdu" else pdu.add_ce)(lcid, payload)
        tb = None if trial % 2 else 1200
        raw = pdus[0].pack(tb_size=tb)
        assert pdus[1].pack(tb_size=tb) == raw
        jg, tg = j_pdu.MacPduNr.unpack(raw, is_ul), t_pdu.MacPduNr.unpack(raw, is_ul)
        assert jg.subpdus == tg.subpdus and tg.sdus() == jg.sdus() and tg.ces() == jg.ces()
    assert t_pdu.LCID_PAD == j_pdu.LCID_PAD


# ------------------------------------------------------------------ HARQ-NR
def test_tx_harq_rv_cycling_and_drop():
    assert t_harq.RV_SEQ_NR == j_harq.RV_SEQ_NR and t_harq.N_PROC_NR == j_harq.N_PROC_NR == 16
    for max_retx in (0, 2, 4):
        seen = []
        for m in (j_harq, t_harq):
            ent = m.NrTxHarqEntity(max_retx=max_retx)
            pid = ent.free_pid()
            log = [ent.new_tx(pid, np.zeros(8, np.uint8))]
            while (nr := ent.retx(pid)) is not None:
                log.append(nr)
            log.append((ent.procs[pid].active, ent.free_pid()))
            ent.new_tx(ent.free_pid(), np.zeros(8, np.uint8))
            ent.ack(0)
            log.append(tuple(p.active for p in ent.procs[:2]))
            seen.append(log)
        assert seen[0] == seen[1]


def _llr(cfg, bits, rng, sigma):
    """tests/test_nr_worker.py's LLRs of one transmission (encoded by the
    port; the encoders are held equal in tests/test_torch_nr.py)."""
    x = t_dlsch.nr_dlsch_encode(bits, cfg, device=CPU).numpy()
    y = (1.0 - 2.0 * x) + sigma * rng.standard_normal(cfg.G)
    return (-2.0 * y / sigma**2).astype(np.float32)


def test_harq_ir_combining_and_entity():
    """The analog of test_harq_ir_combining_recovers_failed_first_tx and
    test_dl_harq_entity_ndi_toggle_and_duplicate_ack: the same LLRs through
    both packages' soft buffers and entities."""
    rng = np.random.default_rng(5)
    kw = dict(tbs=2152, G=3456, Qm=4, rate=0.64)
    jc0, jc2 = J.NrDlschConfig(**kw), J.NrDlschConfig(**kw, rv=2)
    tc0, tc2 = T.NrDlschConfig(**kw), T.NrDlschConfig(**kw, rv=2)
    bits = rng.integers(0, 2, 2152).astype(np.uint8)
    l0, l2 = _llr(tc0, bits, rng, 1.15), _llr(tc2, bits, rng, 1.15)
    js = j_dlsch.nr_dlsch_combine(jnp.asarray(l2), jc2, j_dlsch.nr_dlsch_combine(
        jnp.asarray(l0), jc0))
    ts = t_dlsch.nr_dlsch_combine(l2, tc2, t_dlsch.nr_dlsch_combine(l0, tc0, device=CPU),
                                  device=CPU)
    scale = float(np.abs(np.asarray(js)).max())
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0, atol=1e-5 * scale)
    # rv 0 alone fails in both; the combined buffer decodes in both
    jent, tent = j_harq.NrDlHarqEntity(), t_harq.NrDlHarqEntity()
    ja, jb = jent.rx(3, 1, jnp.asarray(l0), jc0)
    ta, tb = tent.rx(3, 1, torch.as_tensor(l0), tc0)
    assert ja is ta is False and jb is tb is None
    ja, jb = jent.rx(3, 1, jnp.asarray(l2), jc2, n_iter=20)
    ta, tb = tent.rx(3, 1, torch.as_tensor(l2), tc2, n_iter=20)
    assert ja is True and ta is True
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tb, bits)
    assert tent.procs[3].n_retx == jent.procs[3].n_retx == 1 and tent.procs[3].state is None
    # a duplicate is acked again without a decode; an NDI toggle is a new TB
    assert tent.rx(3, 1, torch.as_tensor(l0), tc0) == (True, None)
    b2 = rng.integers(0, 2, 2152).astype(np.uint8)
    cfg = dict(tbs=2152, G=6912, Qm=4, rate=0.32)
    l_new = _llr(T.NrDlschConfig(**cfg), b2, rng, 0.5)
    ja, jb = jent.rx(3, 0, jnp.asarray(l_new), J.NrDlschConfig(**cfg))
    ta, tb = tent.rx(3, 0, torch.as_tensor(l_new), T.NrDlschConfig(**cfg))
    assert ja and ta and np.array_equal(tb, jb) and np.array_equal(tb, b2)
    assert tent.procs[3].n_retx == jent.procs[3].n_retx == 0


# ------------------------------------------------------------------ VNF
def test_vnf_codecs_bytes():
    rng = np.random.default_rng(11)
    pdus = [(t_vnf.PDSCH, rand_bytes(rng, 300)), (t_vnf.PDCCH, rand_bytes(rng, 7))]
    for fn, args in (("pack_sf_ind", (1, 2, 3)), ("pack_dl_config", (4, 5, 6, 7)),
                     ("pack_tx_request", (42, pdus)), ("pack_rx_data_ind", (7, 12, 3, pdus)),
                     ("pack_dl_ind", (1, 9, pdus)), ("pack_ul_ind", (1, 2, 0x4601, 4, 99))):
        raw = getattr(j_vnf, fn)(*args)
        assert getattr(t_vnf, fn)(*args) == raw, fn
        assert t_vnf._unpack(raw) == j_vnf._unpack(raw)
    body = t_vnf._unpack(t_vnf.pack_tx_request(42, pdus))[1]
    assert t_vnf.unpack_tx_request(body) == j_vnf.unpack_tx_request(body) == (42, pdus)
    body = t_vnf._unpack(t_vnf.pack_rx_data_ind(7, 12, 3, pdus))[1]
    assert t_vnf.unpack_rx_data_ind(body) == j_vnf.unpack_rx_data_ind(body) == (12, 3, pdus)
    body = t_vnf._unpack(t_vnf.pack_dl_ind(1, 9, pdus))[1]
    assert t_vnf.unpack_dl_ind(body) == j_vnf.unpack_dl_ind(body) == (9, pdus)
    with pytest.raises(ValueError):
        t_vnf._unpack(t_vnf.pack_dl_ind(1, 9, pdus)[:-1])


def _common(pkg, **kw):
    """The workers' configuration on a 24 PRB carrier (one L=4 candidate)."""
    car = pkg.NrCarrier(n_prb=24, n_id=33)
    return dict(carrier=car, coreset=pkg.Coreset.full(24, duration=1, id=1), mcs=20,
                prb_start=0, n_prb=24, **kw)


def _links(v):
    """Two cross-wired loopback UDP pairs on ephemeral ports (test_vnf.py)."""
    a = v._Udp(0, 0)
    b = v._Udp(0, a.port)
    a.peer = ("127.0.0.1", b.port)
    return a, b


def test_vnf_split_port_pnf_with_reference_vnf():
    """A MAC TB queued at the JAX package's GnbVnf crosses the UDP split to the
    port's GnbPnf, is encoded by the port's worker, decoded by the port's
    UePnf and arrives at the JAX package's UeVnf as a DL_IND PDU (the wire
    and the message codecs of both packages are one); the ACK clears the
    HARQ process."""
    common = t_worker.NrWorkerCommon(**_common(T, device=CPU))
    gnb_pnf_link, gnb_vnf_link = _links(t_vnf)
    ue_pnf_link, ue_vnf_link = _links(t_vnf)
    gnb_pnf = t_vnf.GnbPnf(t_worker.GnbNrWorker(common), gnb_pnf_link)
    gnb_vnf = j_vnf.GnbVnf(gnb_vnf_link)
    ue_pnf = t_vnf.UePnf(t_worker.UeNrWorker(common), ue_pnf_link)
    ue_vnf = j_vnf.UeVnf(ue_vnf_link)
    tbs = common.phy_grant(0).tbs
    tb = rand_bytes(np.random.default_rng(4), tbs // 8)
    gnb_vnf.tx_queue.append(tb)
    th = threading.Thread(target=gnb_vnf.handle_one)
    th.start()
    grid = gnb_pnf.run_slot(0)
    th.join()
    assert grid is not None and grid.shape == (14, 24 * 12)
    ul = ue_pnf.run_slot(grid, 0)
    assert ul is not None
    assert ue_vnf.handle_one() == j_vnf.DL_IND
    gnb_pnf.worker.rx_ul_slot(ul, 0)
    assert not gnb_pnf.worker._awaiting and not gnb_pnf.worker._nacked
    assert ue_vnf.rx_tbs == [tb]
    for link in (gnb_pnf_link, gnb_vnf_link, ue_pnf_link, ue_vnf_link):
        link.close()


# ------------------------------------------------- workers and stack lockstep
def _noise(rng, shape, snr_db):
    sigma = 10 ** (-snr_db / 20) / np.sqrt(2)
    return (sigma * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


def _spy(worker, seen):
    """Record (pid, ndi, rv) of every transmission the UE's DCI leads its
    HARQ entity to."""
    rx = worker.harq.rx

    def spy(pid, ndi, llr, cfg, **kw):
        seen.append((pid, ndi, cfg.rv))
        return rx(pid, ndi, llr, cfg, **kw)
    worker.harq.rx = spy


def test_nr_stack_lockstep():
    """GnbNrStack -> GnbNrWorker -> (AWGN) -> UeNrWorker -> UeNrStack in both
    packages on the same noise, three slots at slot number 0: a TB sent at
    10.5 dB (rv 0 fails: NACK on the PUCCH), its rv 2 retransmission at the
    same SNR (combined, ACK, delivered), then the next TB at 20 dB.  The DL
    and UL grids within 1e-5 of their largest magnitude, the DCI each UE
    reads, the ACK each gNB decodes, the bits delivered and the packets out
    of PDCP equal; the ciphered packets arrive in order, the second over two
    RLC segments."""
    jc = j_worker.NrWorkerCommon(**_common(J))
    tc = t_worker.NrWorkerCommon(**_common(T, device=CPU))
    tbs = tc.phy_grant(0).tbs
    assert jc.phy_grant(0).tbs == tbs
    jg, ju = j_worker.GnbNrWorker(jc), j_worker.UeNrWorker(jc)
    tg, tu = t_worker.GnbNrWorker(tc), t_worker.UeNrWorker(tc)
    js, jr = j_stack.GnbNrStack(jg, k_enc=KEY), j_stack.UeNrStack(ju, k_enc=KEY)
    ts, tr = t_stack.GnbNrStack(tg, k_enc=KEY), t_stack.UeNrStack(tu, k_enc=KEY)
    rng = np.random.default_rng(3)
    pkts = [rand_bytes(rng, 120), rand_bytes(rng, 3 * (tbs // 8) // 2)]
    for s in (js, ts):
        for p in pkts:
            s.send_packet(p)
        s.pump_tx()
    assert len(jg.queue) == len(tg.queue) == 3
    for i, q in enumerate(jg.queue):
        np.testing.assert_array_equal(tg.queue[i], q)
    jseen, tseen, acks = [], [], []
    _spy(ju, jseen)
    _spy(tu, tseen)
    for snr in (10.5, 10.5, 20.0):
        gj, gt = jg.tx_slot(0), tg.tx_slot(0)
        scale = float(np.abs(np.asarray(gj)).max())
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-5 * scale)
        rx = np.asarray(gj) + _noise(rng, gj.shape, snr)
        uj = ju.rx_slot(jnp.asarray(rx), 0)
        ut = tu.rx_slot(torch.as_tensor(rx), 0)
        assert jseen == tseen
        scale = float(np.abs(np.asarray(uj)).max())
        np.testing.assert_allclose(ut.numpy(), np.asarray(uj), rtol=0, atol=1e-5 * scale)
        assert len(ju.delivered) == len(tu.delivered)
        for a, b in zip(ju.delivered, tu.delivered):
            np.testing.assert_array_equal(b, np.asarray(a))
        jg.rx_ul_slot(uj, 0)
        tg.rx_ul_slot(ut, 0)
        assert jg._nacked == tg._nacked and jg._awaiting == tg._awaiting == {}
        acks.append(not tg._nacked)
        jr.pump_rx()
        tr.pump_rx()
        assert tr.received == jr.received
    assert tseen == [(0, 1, 0), (0, 1, 2), (0, 0, 0)]  # (pid, ndi, rv) of each DCI read
    assert acks == [False, True, True]
    assert tr.received == pkts[:1] and tr.pdcp.rx_next == 1
    # the rest of the segmented packet, noiseless, on the port alone
    while tg.queue or tg._nacked or tg._awaiting:
        tg.rx_ul_slot(tu.rx_slot(tg.tx_slot(0), 0), 0)
        tr.pump_rx()
    assert tr.received == pkts and tr.pdcp.rx_next == len(pkts) and tg.dropped == 0


def test_workers_need_a_device():
    """device=None means the CUDA device: a worker's first slot raises where
    there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    common = t_worker.NrWorkerCommon(**_common(T))
    g = t_worker.GnbNrWorker(common)
    g.tx_data(np.zeros(common.phy_grant(0).tbs, np.uint8))
    with pytest.raises(RuntimeError, match="CUDA"):
        g.tx_slot(0)
