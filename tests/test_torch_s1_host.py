"""The port's S1 host modules against the JAX package's, on the CPU.

`srslte_tpu_torch.s1ap`, `epc.gtpc`, `net.s1_transport`, `epc.mbms_gw` and
`utils.{config,crash,metrics,pcap,sysmetrics,tprof,trace}` are copies of the
JAX package's host modules (the port imports nothing of that package).  The
same seeded inputs go through both and the outputs are held byte- or
value-equal: every S1AP procedure, every GTP-C message type, the framed
S1AP stream, the pcap files, the parsed configuration and the metrics lines.
Then the analogs of tests/test_s1ap.py, tests/test_utils.py,
tests/test_s1_wire.py::test_gtpc_codec_roundtrip and the pcap, MBMS, crash,
tprof and sysmetrics cases of tests/test_aux_subsystems.py run on the port.
"""

import json
import socket
import struct
import sys
import time

import numpy as np
import pytest

import srslte_tpu.epc.gtpc as j_gtpc
import srslte_tpu.net.s1_transport as j_s1t
import srslte_tpu.s1ap as j_s1ap
import srslte_tpu.utils.config as j_config
import srslte_tpu.utils.metrics as j_metrics
import srslte_tpu.utils.pcap as j_pcap
import srslte_tpu_torch.epc.gtpc as t_gtpc
import srslte_tpu_torch.net.s1_transport as t_s1t
import srslte_tpu_torch.s1ap as t_s1ap
import srslte_tpu_torch.utils.config as t_config
import srslte_tpu_torch.utils.metrics as t_metrics
import srslte_tpu_torch.utils.pcap as t_pcap
from srslte_tpu_torch.s1ap import s1ap_pack, s1ap_unpack

PLMN = b"\x00\xf1\x10"


# ------------------------------------------------------------ seeded S1AP
def _cause(rng):
    return [("radio_network", "user_inactivity"), ("nas", "detach"),
            ("transport", "unspecified"), ("misc", "om_intervention"),
            ("protocol", "semantic_error")][int(rng.integers(5))]


def _addr(rng):
    return (int(rng.integers(0, 2**32)), 32)


def _ies(proc, rng):
    """IE values for `proc` drawn from rng (the shapes the live path and the
    reference's vectors use)."""
    mme, enb = int(rng.integers(0, 2**32)), int(rng.integers(0, 2**24))
    nas = rng.integers(0, 256, int(rng.integers(2, 300)), dtype=np.uint8).tobytes()
    tai = {"plmn": PLMN, "tac": rng.integers(0, 256, 2, dtype=np.uint8).tobytes()}
    cgi = {"plmn": PLMN, "cell_id": int(rng.integers(0, 2**28))}
    teid = rng.integers(0, 256, 4, dtype=np.uint8).tobytes()
    return {
        "s1_setup_request": {
            "global_enb_id": {"plmn": PLMN, "enb_id": ("macro", int(rng.integers(0, 2**20)))},
            "enb_name": f"srsenb{int(rng.integers(100)):02d}",
            "supported_tas": [{"tac": tai["tac"], "plmns": [PLMN]}],
            "default_paging_drx": ["v32", "v64", "v128", "v256"][int(rng.integers(4))]},
        "s1_setup_response": {
            "mme_name": "srsmme01",
            "served_gummeis": [{"plmns": [PLMN], "group_ids": [teid[:2]], "mmecs": [teid[2:3]]}],
            "relative_mme_capacity": int(rng.integers(256))},
        "s1_setup_failure": {"cause": _cause(rng), "time_to_wait": "v10s"},
        "initial_ue_message": {
            "enb_ue_id": enb, "nas_pdu": nas, "tai": tai, "eutran_cgi": cgi,
            "establishment_cause": "mo_signalling"},
        "downlink_nas_transport": {"mme_ue_id": mme, "enb_ue_id": enb, "nas_pdu": nas},
        "uplink_nas_transport": {"mme_ue_id": mme, "enb_ue_id": enb, "nas_pdu": nas,
                                 "eutran_cgi": cgi, "tai": tai},
        "initial_context_setup_request": {
            "mme_ue_id": mme, "enb_ue_id": enb,
            "ue_aggregate_max_bitrate": {"dl": int(rng.integers(10**9)),
                                         "ul": int(rng.integers(10**9))},
            "erab_to_be_setup_list": [{"item": {
                "erab_id": 5,
                "qos": {"qci": 9, "arp": {"priority_level": 15,
                                          "pre_emption_capability": "shall_not_trigger",
                                          "pre_emption_vulnerability": "not_pre_emptable"}},
                "transport_address": _addr(rng), "gtp_teid": teid, "nas_pdu": nas}}],
            "ue_security_capabilities": {"eea": 0b1100000000000000,
                                         "eia": 0b1100000000000000},
            "security_key": int.from_bytes(rng.integers(0, 256, 32, dtype=np.uint8)
                                           .tobytes(), "big"),
            "_raw_401": ("ignore", int(rng.integers(2**16)).to_bytes(2, "big"))},
        "initial_context_setup_response": {
            "mme_ue_id": mme, "enb_ue_id": enb,
            "erab_setup_list": [{"item": {"erab_id": 5, "transport_address": _addr(rng),
                                          "gtp_teid": teid}}],
            "_raw_400": ("ignore", int(rng.integers(2**16)).to_bytes(2, "big"))},
        "ue_context_release_request": {"mme_ue_id": mme, "enb_ue_id": enb,
                                       "cause": _cause(rng)},
        "ue_context_release_command": {
            "ue_s1ap_ids": ("pair", {"mme_ue_id": mme, "enb_ue_id": enb}),
            "cause": _cause(rng)},
        "ue_context_release_complete": {"mme_ue_id": mme, "enb_ue_id": enb},
        "enb_status_transfer": {
            "mme_ue_id": mme, "enb_ue_id": enb,
            "container": {"bearers": [{"item": {
                "erab_id": 5,
                "ul_count": {"pdcp_sn": int(rng.integers(4096)), "hfn": int(rng.integers(2**20))},
                "dl_count": {"pdcp_sn": int(rng.integers(4096)),
                             "hfn": int(rng.integers(2**20))}}}]}},
    }[proc]


def test_the_port_has_every_procedure():
    assert list(t_s1ap.PROCEDURES) == list(j_s1ap.PROCEDURES)


@pytest.mark.parametrize("proc", sorted(j_s1ap.PROCEDURES))
@pytest.mark.parametrize("seed", [0, 1])
def test_s1ap_bytes_equal_across_packages(proc, seed):
    ies = _ies(proc, np.random.default_rng(1000 * seed + sorted(j_s1ap.PROCEDURES).index(proc)))
    raw = j_s1ap.s1ap_pack(proc, ies)
    assert t_s1ap.s1ap_pack(proc, ies) == raw
    assert t_s1ap.s1ap_unpack(raw) == j_s1ap.s1ap_unpack(raw) == (proc, ies)


# ------------------------------------------------------------ GTP-C
def _gtpc_pdus(m):
    rng = np.random.default_rng(7)

    def fteid():
        ip = ".".join(str(int(x)) for x in rng.integers(0, 256, 4))
        return m.Fteid(int(rng.integers(2**32)), ip, int(rng.integers(2**16)))

    return [
        m.GtpcPdu(m.CREATE_SESSION_REQUEST, sequence=3, imsi=1010123456789, mme_ctrl_teid=3),
        m.GtpcPdu(m.CREATE_SESSION_RESPONSE, teid=7, sequence=3, imsi=1010123456789,
                  mme_ctrl_teid=3, user_fteid=fteid(), paa="172.16.0.2"),
        m.GtpcPdu(m.MODIFY_BEARER_REQUEST, teid=1, user_fteid=fteid()),
        m.GtpcPdu(m.MODIFY_BEARER_RESPONSE, teid=1, sequence=9, ebi=6),
        m.GtpcPdu(m.DELETE_SESSION_REQUEST, teid=9),
        m.GtpcPdu(m.DELETE_SESSION_RESPONSE, teid=9, sequence=4, cause=64),
        m.GtpcPdu(m.RELEASE_ACCESS_BEARERS_REQUEST, teid=2, sequence=5),
        m.GtpcPdu(m.RELEASE_ACCESS_BEARERS_RESPONSE, teid=2, sequence=5),
        m.GtpcPdu(m.DOWNLINK_DATA_NOTIFICATION, teid=3, imsi=1010000000001),
        m.GtpcPdu(m.DOWNLINK_DATA_NOTIFICATION_ACK, teid=3, sequence=11),
    ]


@pytest.mark.parametrize("i", range(10))
def test_gtpc_bytes_equal_across_packages(i):
    j, t = _gtpc_pdus(j_gtpc)[i], _gtpc_pdus(t_gtpc)[i]
    raw = j.pack()
    assert t.pack() == raw
    got = t_gtpc.GtpcPdu.unpack(raw)
    assert got == t and vars(j_gtpc.GtpcPdu.unpack(raw)).keys() == vars(got).keys()
    assert repr(j_gtpc.GtpcPdu.unpack(raw)) == repr(got)


def test_gtpc_codec_roundtrip():
    """Analog of tests/test_s1_wire.py::test_gtpc_codec_roundtrip."""
    pdu = t_gtpc.GtpcPdu(t_gtpc.CREATE_SESSION_RESPONSE, teid=7, sequence=3,
                         imsi=1010123456789, mme_ctrl_teid=3,
                         user_fteid=t_gtpc.Fteid(0x1234, "127.0.0.1", 40002),
                         paa="172.16.0.2")
    out = t_gtpc.GtpcPdu.unpack(pdu.pack())
    assert out == pdu
    bare = t_gtpc.GtpcPdu(t_gtpc.DELETE_SESSION_REQUEST, teid=9)
    assert t_gtpc.GtpcPdu.unpack(bare.pack()) == bare


# ------------------------------------------------------------ framed S1AP
@pytest.mark.parametrize("cuts", [(1,), (3, 7), (4,), (5, 6, 40), tuple(range(1, 60, 3))],
                         ids=lambda c: f"cuts{len(c)}")
def test_framed_stream_reassembly_across_packages(cuts):
    """The TCP fallback's 4-byte length frames, the stream split at `cuts`
    into separate reads: both packages reassemble the same PDUs."""
    rng = np.random.default_rng(len(cuts))
    pdus = [s1ap_pack(p, _ies(p, rng)) for p in ("s1_setup_request", "initial_ue_message",
                                                 "downlink_nas_transport")]
    stream = b"".join(struct.pack("!I", len(p)) + p for p in pdus)
    out = {}
    for name, mod in (("jax", j_s1t), ("port", t_s1t)):
        a, b = socket.socketpair()
        try:
            rx = mod._Framed(b, framed=True)
            got, pos = [], 0
            for cut in sorted(set(cuts)) + [len(stream)]:
                a.sendall(stream[pos:cut])
                pos = cut
                got += rx.poll()
            for _ in range(200):  # what a last read left in the buffer
                if len(got) >= len(pdus):
                    break
                time.sleep(0.005)
                got += rx.poll()
            out[name] = got
        finally:
            a.close()
            b.close()
    assert out["port"] == out["jax"] == pdus


def test_framed_send_writes_the_length_frame():
    a, b = socket.socketpair()
    try:
        t_s1t._Framed(a, framed=True).send(b"\x00\x11\x22")
        assert b.recv(64) == b"\x00\x00\x00\x03\x00\x11\x22"
    finally:
        a.close()
        b.close()


# ------------------------------------------------------------ pcap, config, metrics
def _pcap_files(mod, tmp, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1700000000.25)
    paths = {k: str(tmp / f"{k}.pcap") for k in ("mac", "nas", "s1ap", "rlc")}
    w = mod.MacPcap(paths["mac"])
    w.write_pdu(b"\x3f\x01\x02\x03", rnti=0x46, tti=3)
    w.write_pdu(bytes(range(40)), rnti=0x47, tti=1234)
    w.close()
    w = mod.NasPcap(paths["nas"])
    w.write_pdu(b"\x07\x41\x01")
    w.close()
    w = mod.S1apPcap(paths["s1ap"])
    w.write_pdu(s1ap_pack("downlink_nas_transport",
                          {"mme_ue_id": 7, "enb_ue_id": 1, "nas_pdu": b"\x07\x52"}))
    w.close()
    w = mod.RlcPcap(paths["rlc"], ue_id=7)
    w.write_pdu(b"\x88\x00payload", mode=mod.RLC_AM_MODE, lcid=1)
    w.write_pdu(b"\x99", mode=mod.RLC_UM_MODE, lcid=3, is_srb=False)
    w.close()
    return {k: open(p, "rb").read() for k, p in paths.items()}


def test_pcap_bytes_equal_across_packages(tmp_path, monkeypatch):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    j = _pcap_files(j_pcap, tmp_path / "j", monkeypatch)
    t = _pcap_files(t_pcap, tmp_path / "t", monkeypatch)
    assert t == j and all(len(v) > 24 for v in t.values())


def _config(mod, path):
    cfg = mod.Config()
    cfg.declare("rf.srate", 1920000)
    cfg.declare("phy.nof_threads", 1)
    cfg.declare("phy.snr_ema", 0.1)
    cfg.declare("log.enable", False)
    cfg.declare("enb.name", "srsenb01")
    cfg.load_file(path)
    rest = cfg.load_args(["--phy.nof_threads=4", "--log.enable=true", "--enb.name=x", "pos"])
    return rest, cfg.as_dict()


def test_config_equal_across_packages(tmp_path):
    p = tmp_path / "enb.conf"
    p.write_text("[rf]\nsrate = 23040000\n[phy]\nnof_threads = 3\nsnr_ema = 0.25\n")
    assert _config(t_config, str(p)) == _config(j_config, str(p))


def _metrics(mod, tmp):
    hub = mod.MetricsHub(period_s=100)
    state = {"n": 0}

    def phy():
        state["n"] += 1
        return {"bler": 0.01 * state["n"], "snr_db": 21.5, "mcs": 27}

    hub.add_producer("phy", phy)
    hub.add_producer("mac", lambda: {"tx_pkts": 5, "rx_brate": 1.5e6})
    c = mod.CsvListener(str(tmp / "m.csv"), ["phy.bler", "mac.tx_pkts", "phy.none"])
    jl = mod.JsonLinesListener(str(tmp / "m.jsonl"))
    hub.add_listener(c)
    hub.add_listener(jl)
    for _ in range(3):
        hub.poll_once()
    c.close()
    jl.close()
    lines = [json.loads(x) for x in open(tmp / "m.jsonl").read().splitlines()]
    for x in lines:
        x.pop("ts", None)  # the wall clock of the poll
    return open(tmp / "m.csv").read(), lines


def test_metrics_lines_equal_across_packages(tmp_path):
    (tmp_path / "j").mkdir()
    (tmp_path / "t").mkdir()
    assert _metrics(t_metrics, tmp_path / "t") == _metrics(j_metrics, tmp_path / "j")


# ------------------------------------------------------------ tests/test_s1ap.py
def _vectors():
    import test_s1ap as ref  # the reference's committed byte vectors (tests/ is on the path)

    return ref


@pytest.mark.parametrize("name", ["ue_ctxt_release_req", "init_ctxt_setup_req",
                                  "s1_setup_resp", "icsr_small", "ics_resp"])
def test_reference_vector_roundtrip(name):
    raw = _vectors().ALL[name]
    proc, ies = s1ap_unpack(raw)
    assert s1ap_pack(proc, ies) == raw
    assert (proc, ies) == j_s1ap.s1ap_unpack(raw)


def test_ue_ctxt_release_req_semantics():
    proc, ies = s1ap_unpack(_vectors().UE_CTXT_RELEASE_REQ)
    assert proc == "ue_context_release_request"
    assert ies["mme_ue_id"] == 1 and ies["enb_ue_id"] == 1
    assert ies["cause"] == ("radio_network", "user_inactivity")


def test_init_ctxt_setup_req_semantics():
    proc, ies = s1ap_unpack(_vectors().INIT_CTXT_SETUP_REQ)
    assert proc == "initial_context_setup_request"
    caps = ies["ue_security_capabilities"]
    assert caps["eea"] == 0b1100000000000000
    assert caps["eia"] == 0b1100000000000000
    assert ies["ue_aggregate_max_bitrate"] == {"dl": 10**9, "ul": 10**9}
    item = ies["erab_to_be_setup_list"][0]["item"]
    assert item["erab_id"] == 5
    assert item["qos"]["qci"] == 9
    assert item["gtp_teid"] == bytes.fromhex("b7361c56")


def test_icsr_small_semantics():
    proc, ies = s1ap_unpack(_vectors().ICSR_SMALL)
    item = ies["erab_to_be_setup_list"][0]["item"]
    assert item["transport_address"] == (0x7f000164, 32)
    assert item["gtp_teid"] == bytes([0, 0, 0, 1])
    assert ies["security_key"] is not None


def test_s1_setup_resp_semantics():
    proc, ies = s1ap_unpack(_vectors().S1_SETUP_RESP)
    assert proc == "s1_setup_response"
    assert ies["mme_name"] == "srsmme01"
    g = ies["served_gummeis"][0]
    assert g["plmns"] == [bytes.fromhex("00f110")]
    assert g["group_ids"] == [bytes.fromhex("0100")]
    assert g["mmecs"] == [bytes([0x1a])]
    assert ies["relative_mme_capacity"] == 0xFF


def test_ics_resp_semantics():
    proc, ies = s1ap_unpack(_vectors().ICS_RESP)
    assert proc == "initial_context_setup_response"
    item = ies["erab_setup_list"][0]["item"]
    assert item["erab_id"] == 5
    assert item["transport_address"] == (0x7f000101, 32)


def test_pack_attach_path_messages():
    """Round-trip every procedure the live S1 path uses (the reference's
    own IE values)."""
    cases = {
        "s1_setup_request": {
            "global_enb_id": {"plmn": PLMN, "enb_id": ("macro", 0x19B)},
            "enb_name": "srsenb01",
            "supported_tas": [{"tac": b"\x00\x07", "plmns": [PLMN]}],
            "default_paging_drx": "v128"},
        "initial_ue_message": {
            "enb_ue_id": 1, "nas_pdu": b"\x07\x41\x01",
            "tai": {"plmn": PLMN, "tac": b"\x00\x07"},
            "eutran_cgi": {"plmn": PLMN, "cell_id": 0x19B01},
            "establishment_cause": "mo_signalling"},
        "downlink_nas_transport": {"mme_ue_id": 7, "enb_ue_id": 1, "nas_pdu": b"\x07\x52\x00"},
        "uplink_nas_transport": {
            "mme_ue_id": 7, "enb_ue_id": 1, "nas_pdu": b"\x07\x53",
            "eutran_cgi": {"plmn": PLMN, "cell_id": 0x19B01},
            "tai": {"plmn": PLMN, "tac": b"\x00\x07"}},
        "ue_context_release_command": {
            "ue_s1ap_ids": ("pair", {"mme_ue_id": 7, "enb_ue_id": 1}),
            "cause": ("nas", "detach")},
        "ue_context_release_complete": {"mme_ue_id": 7, "enb_ue_id": 1},
        "enb_status_transfer": {
            "mme_ue_id": 7, "enb_ue_id": 1,
            "container": {"bearers": [{"item": {
                "erab_id": 5, "ul_count": {"pdcp_sn": 4, "hfn": 0},
                "dl_count": {"pdcp_sn": 5, "hfn": 0}}}]}},
    }
    for proc, ies in cases.items():
        raw = s1ap_pack(proc, ies)
        proc2, ies2 = s1ap_unpack(raw)
        assert proc2 == proc
        assert ies2 == ies, proc


# ------------------------------------------------------------ tests/test_utils.py
def test_tracer_chrome_format(tmp_path):
    from srslte_tpu_torch.utils.trace import Tracer

    t = Tracer(enabled=True)
    with t.span("phy", "decode_subframe", tti=4):
        t.instant("phy", "crc_ok")
    p = str(tmp_path / "trace.json")
    t.save(p)
    evs = json.load(open(p))["traceEvents"]
    assert any(e["ph"] == "X" and e["name"] == "decode_subframe" for e in evs)
    assert any(e["ph"] == "i" and e["name"] == "crc_ok" for e in evs)


def test_tracer_disabled_is_free():
    from srslte_tpu_torch.utils.trace import Tracer

    t = Tracer(enabled=False)
    with t.span("a", "b"):
        pass
    assert t.events == []


def test_metrics_hub_fanout(tmp_path):
    hub = t_metrics.MetricsHub(period_s=100)
    hub.add_producer("phy", lambda: {"bler": 0.01, "snr_db": 21.5})
    hub.add_producer("mac", lambda: {"tx_pkts": 5})
    csv_p, jl_p = str(tmp_path / "m.csv"), str(tmp_path / "m.jsonl")
    c = t_metrics.CsvListener(csv_p, ["phy.bler", "mac.tx_pkts"])
    j = t_metrics.JsonLinesListener(jl_p)
    hub.add_listener(c)
    hub.add_listener(j)
    snap = hub.poll_once()
    assert snap["phy"]["snr_db"] == 21.5
    c.close(), j.close()
    rows = open(csv_p).read().strip().split("\n")
    assert rows[0] == "phy.bler,mac.tx_pkts"
    assert rows[1] == "0.01,5"
    assert json.loads(open(jl_p).read())["mac"]["tx_pkts"] == 5


def test_metrics_hub_broken_producer():
    hub = t_metrics.MetricsHub()
    hub.add_producer("bad", lambda: 1 / 0)
    assert "error" in hub.poll_once()["bad"]


def test_config_file_and_cli(tmp_path):
    p = tmp_path / "ue.conf"
    p.write_text("[rf]\nsrate = 23040000\n[phy]\nnof_threads = 3\n")
    cfg = t_config.Config()
    cfg.declare("rf.srate", 1920000)
    cfg.declare("phy.nof_threads", 1)
    cfg.declare("phy.snr_ema", 0.1)
    cfg.declare("log.enable", False)
    cfg.load_file(str(p))
    rest = cfg.load_args(["--phy.nof_threads=4", "--log.enable=true", "pos"])
    assert rest == ["pos"]
    assert cfg.get("rf.srate") == 23040000
    assert cfg.get("phy.nof_threads") == 4
    assert cfg.get("phy.snr_ema") == 0.1
    assert cfg.get("log.enable") is True


def test_mac_pcap_writes_valid_file(tmp_path):
    p = str(tmp_path / "mac.pcap")
    pc = t_pcap.MacPcap(p)
    pc.write_pdu(b"\x3f\x01\x02\x03", rnti=0x46, tti=3)
    pc.close()
    raw = open(p, "rb").read()
    assert struct.unpack("<I", raw[:4])[0] == 0xA1B2C3D4
    assert b"mac-lte" in raw


def test_metrics_stdout_table():
    import io

    buf = io.StringIO()
    hub = t_metrics.MetricsHub(period_s=0.01)
    state = {"snr": 21.4567, "mcs": 27}
    hub.add_producer("phy", lambda: dict(state))
    hub.add_listener(t_metrics.StdoutTableListener(
        [("snr", "phy.snr"), ("mcs", "phy.mcs"), ("bler", "phy.bler")],
        header_every=2, out=buf))
    for _ in range(4):
        hub.poll_once()
    lines = [x for x in buf.getvalue().splitlines() if x]
    assert len(lines) == 6
    assert lines[0].split() == ["snr", "mcs", "bler"]
    assert lines[1].split() == ["21.5", "27", "-"]
    assert lines[3] == lines[0]


# ------------------------------------------------------------ tests/test_aux_subsystems.py
def _read_pcap(path):
    data = open(path, "rb").read()
    magic, _, _, _, _, _, dlt = struct.unpack("<IHHiIII", data[:24])
    assert magic == 0xA1B2C3D4
    pkts, off = [], 24
    while off < len(data):
        _, _, incl, _ = struct.unpack("<IIII", data[off : off + 16])
        pkts.append(data[off + 16 : off + 16 + incl])
        off += 16 + incl
    return dlt, pkts


def test_nas_s1ap_pcap_raw_dlt(tmp_path):
    p = tmp_path / "nas.pcap"
    w = t_pcap.NasPcap(str(p))
    w.write_pdu(b"\x07\x41\x01")
    w.write_pdu(b"\x07\x42")
    w.close()
    assert _read_pcap(p) == (148, [b"\x07\x41\x01", b"\x07\x42"])
    p2 = tmp_path / "s1ap.pcap"
    w = t_pcap.S1apPcap(str(p2))
    w.write_pdu(b"\x00\x11\x22")
    w.close()
    assert _read_pcap(p2) == (150, [b"\x00\x11\x22"])


def test_rlc_pcap_framing(tmp_path):
    p = tmp_path / "rlc.pcap"
    w = t_pcap.RlcPcap(str(p), ue_id=7)
    w.write_pdu(b"\x88\x00payload", mode=t_pcap.RLC_AM_MODE, lcid=1)
    w.write_pdu(b"\x99", mode=t_pcap.RLC_UM_MODE, lcid=3, is_srb=False)
    w.close()
    dlt, pkts = _read_pcap(p)
    assert dlt == 149
    assert pkts[0][:2] == b"\xde\xad" and pkts[0][8:15] == b"rlc-lte"
    assert pkts[0][15] == t_pcap.RLC_AM_MODE
    assert pkts[0].endswith(b"\x88\x00payload")
    assert pkts[1][15] == t_pcap.RLC_UM_MODE
    assert pkts[1][16] == 0x02


def test_mac_pcap_net_live_export():
    rx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    rx.bind(("127.0.0.1", 0))
    rx.settimeout(2.0)
    net = t_pcap.MacPcapNet(port=rx.getsockname()[1], ue_id=7)
    net.write_pdu(b"\x3f\x01\x02", rnti=0x46, tti=13, direction=1)
    dgram = rx.recv(2048)
    net.close()
    rx.close()
    assert dgram.startswith(t_pcap.MAC_LTE_START)
    assert dgram.endswith(b"\x3f\x01\x02")
    assert struct.pack("!H", 0x46) in dgram


def test_mbms_gw_data_path():
    """The M1-U path on a port of its own (the reference's test binds
    23452): three multicast packets as GTP-U, unwrapped in order."""
    from srslte_tpu_torch.epc.mbms_gw import EnbM1uRx, MbmsGw

    rx = EnbM1uRx(port=0)
    gw = MbmsGw(m1u_port=rx._sock.getsockname()[1])
    pkts = [bytes([0x45, 0, 0, 20 + i]) + bytes(16 + i) for i in range(3)]
    try:
        for p in pkts:
            gw.sgi_mb_rx(p)
        got = []
        for _ in range(20):
            got.extend(rx.poll())
            if len(got) == 3:
                break
            time.sleep(0.02)
        assert got == pkts
        assert gw.pkts_tx == 3
    finally:
        gw.close()
        rx.close()


def test_crash_handler(tmp_path):
    from srslte_tpu_torch.utils import crash

    path = str(tmp_path / "bt.crash")
    crash.install(path)
    try:
        try:
            raise RuntimeError("boom-for-test")
        except RuntimeError:
            sys.excepthook(*sys.exc_info())
        text = open(path).read()
        assert "crash handler armed" in text and "pid=" in text
        assert "uncaught exception" in text and "boom-for-test" in text
    finally:
        crash.uninstall()


def test_tprof_percentile_probes():
    from srslte_tpu_torch.utils import tprof

    tprof.reset_all()
    tprof.set_enabled(False)
    with tprof.probe("disabled")():
        pass
    assert tprof.probe("disabled").count == 0
    tprof.set_enabled(True)
    try:
        p = tprof.probe("work")
        for i in range(20):
            with p():
                time.sleep(0.0005 * (1 + (i % 3)))
        s = p.stats()
        assert s["count"] == 20
        assert s["min_us"] >= 400
        assert s["p99_us"] >= s["p50_us"] >= s["min_us"]
        assert s["max_us"] >= s["p99_us"]
        assert p.measure(lambda a, b: a + b, 2, 3) == 5 and p.count == 21
        assert [r["name"] for r in tprof.report_all()] == ["work"]
    finally:
        tprof.set_enabled(False)
        tprof.reset_all()


def test_sys_metrics_producer():
    from srslte_tpu_torch.utils.sysmetrics import SysMetrics

    sm = SysMetrics()
    first = sm.get_metrics()
    assert first["proc_rss_mb"] > 1.0
    assert first["threads"] >= 1
    x = 0
    for i in range(2 * 10**6):
        x += i
    second = sm.get_metrics()
    assert second["cpu_percent"] > 0.0
    assert second["sys_mem_free_mb"] > 0.0
    hub = t_metrics.MetricsHub()
    hub.add_producer("sys", sm.get_metrics)
    assert "cpu_percent" in hub.poll_once()["sys"]
