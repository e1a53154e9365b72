"""The port's full stack with the core behind the S1 wire, on the CPU.

`EnbApp(s1=...)` speaks S1AP (SCTP, or the framed-TCP fallback carrying the
same bytes) to a wire `EpcApp`, whose MME drives the S/P-GW over GTP-C on
S11; user data crosses S1-U as GTP-U G-PDUs (srsRAN's srsENB <-> srsEPC
topology, tests/test_s1_wire.py).  At 6 PRB where the reference runs 15,
with the apps on `device="cpu"`:

- the analog of tests/test_s1_wire.py::test_attach_and_data_over_s1_wire on
  the port alone, with every assertion of the reference's;
- the port's apps through the JAX package's `EpcApp` (host code: it compiles
  nothing): every S1AP PDU that crossed the association unpacked by the JAX
  package's codec, each direction's procedures in the reference's order
  (`chip_smoke.S1_JAX`, the JAX apps' own run), and the NAS keys, KeNB and
  AS keys equal on both ends, with the HSS's RAND pinned;
- the analog of tests/test_ttcn3.py::test_ss_attach_over_json_ports.

The MME's S11 exchange blocks on its socket until the S/P-GW answers (the
reference's structure, serviced inline); each test gives that socket a
timeout of its own so that a fault fails the test instead of hanging it.
"""

import os

import pytest
import torch

import chip_smoke as cs
from srslte_tpu_torch.enb import EnbApp
from srslte_tpu_torch.epc import Hss
from srslte_tpu_torch.epc.wire import EpcApp
from srslte_tpu_torch.phy.common.params import Cell
from srslte_tpu_torch.rrc.messages import (ConnectionRequest, ConnectionSetup,
                                           ConnectionSetupComplete, rrc_pack, rrc_unpack)
from srslte_tpu_torch.security.milenage import compute_opc
from srslte_tpu_torch.ttcn3 import JsonPort, SystemSimulator, srb_msg
from srslte_tpu_torch.ue import UeApp
from srslte_tpu_torch.ue_stack import SoftUsim, UeNas

IMSI = "001010123456789"
K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
CPU = "cpu"
N_PRB = 6
S11_TIMEOUT = 5.0  # seconds; the MME's own is 2

torch.set_num_threads(1)  # several test workers share the machine's cores


def _apps(epc, cell, tap=None):
    epc.mme.s11.settimeout(S11_TIMEOUT)
    enb = EnbApp(cell, s1={"port": epc.s1_port, "force_tcp": True}, device=CPU)
    if tap is not None:
        tap(enb)
    ue = UeApp(cell, UeNas(SoftUsim(IMSI, K, compute_opc(K, OP))), device=CPU)

    def step(tti):
        ue.rx_subframe(enb.tx_subframe(tti), tti)
        enb.rx_subframe(ue.tx_subframe(tti), tti)
        epc.step()
    return enb, ue, step


def _attach_and_data(epc, sgi_rx, cell, tap=None):
    """The reference's test body: attach, UL to SGi, DL from SGi."""
    enb, ue, step = _apps(epc, cell, tap)
    tti = 0
    while tti < 400 and ue.nas.state != "attached":
        step(tti)
        tti += 1
    assert ue.nas.state == "attached", f"attach failed: {ue.nas.state}"
    assert enb.s1.setup_done, "S1Setup never completed"
    ectx = enb.ues[ue.crnti]
    assert ectx.teid_ul, "no S1-U uplink TEID from the ICS"
    assert ectx.kenb, "KeNB not carried by InitialContextSetup"
    for _ in range(30):  # settle the DRB reconfiguration
        step(tti)
        tti += 1

    ue.send_data(b"uplink-over-gtpu")
    for _ in range(80):
        step(tti)
        tti += 1
        if sgi_rx:
            break
    assert sgi_rx and sgi_rx[0][1] == b"uplink-over-gtpu"
    ue_ip = sgi_rx[0][0]
    assert ue_ip == ue.nas.ip, "SPGW session IP mismatch"

    assert epc.spgw.send_dl(ue_ip, b"downlink-over-gtpu")
    for _ in range(80):
        step(tti)
        tti += 1
        if ue.rx_data:
            break
    assert ue.rx_data == [b"downlink-over-gtpu"]
    return enb, ue


def test_attach_and_data_over_s1_wire():
    sgi_rx = []
    hss = Hss()
    hss.add_subscriber(IMSI, K, op=OP)
    epc = EpcApp(hss, force_tcp=True, sgi_tx=lambda ip, pkt: sgi_rx.append((ip, pkt)))
    try:
        _attach_and_data(epc, sgi_rx, Cell(n_prb=N_PRB, id=1, nof_ports=1))
    finally:
        epc.close()


@pytest.fixture
def pinned_urandom(monkeypatch):
    """os.urandom as every module of both packages sees it (the HSS's RAND)."""
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) & 0xFF for i in range(n)))


def _reference_order(direction):
    """The S1AP procedures the JAX apps send in one direction before the
    release (chip_smoke.S1_JAX, tests/rehearse_s1.py)."""
    procs = cs.S1_JAX["procedures"]
    procs = procs[: procs.index("ul:ue_context_release_request")]
    return [p.split(":", 1)[1] for p in procs if p.startswith(direction + ":")]


def test_port_apps_through_the_jax_epc(pinned_urandom):
    """The port's EnbApp and UeApp attach and move data through the JAX
    package's wire EpcApp: the S1AP bytes are the reference's."""
    from srslte_tpu.epc import Hss as JHss
    from srslte_tpu.epc.wire import EpcApp as JEpcApp
    from srslte_tpu.nas.keys import kdf_as_keys as j_kdf_as_keys
    from srslte_tpu.nas.keys import kdf_kenb as j_kdf_kenb
    from srslte_tpu.s1ap import s1ap_unpack as j_s1ap_unpack
    from srslte_tpu_torch.nas.keys import kdf_as_keys, kdf_kenb
    from srslte_tpu_torch.security import EEA2, EIA2

    sgi_rx = []
    hss = JHss()
    hss.add_subscriber(IMSI, K, op=OP)
    epc = JEpcApp(hss, force_tcp=True, sgi_tx=lambda ip, pkt: sgi_rx.append((ip, pkt)))
    try:
        cell = Cell(n_prb=N_PRB, id=1, nof_ports=1)
        log, gtpu = [], {}
        enb, ue = _attach_and_data(epc, sgi_rx, cell,
                                   tap=lambda enb: cs.s1_wiretap(enb, epc, [0], log, gtpu))
        procs = [(d, j_s1ap_unpack(raw)[0]) for _, d, raw in log]
        for d in ("ul", "dl"):
            got = [p for dd, p in procs if dd == d]
            want = _reference_order(d)
            assert got[: len(want)] == want, d
        assert gtpu == {"ul": 1, "dl": 1}
        ectx = enb.ues[ue.crnti]
        jctx = epc.mme.ues[ectx.mme_ue_id]
        assert ue.nas.sec.k_int == jctx.sec.k_int and ue.nas.sec.k_enc == jctx.sec.k_enc
        assert ectx.kenb == j_kdf_kenb(jctx.kasme, 0) == kdf_kenb(ue.nas.kasme, 0)
        assert kdf_as_keys(ectx.kenb, EEA2, EIA2) == j_kdf_as_keys(ectx.kenb, EEA2, EIA2)
        assert ectx.pdcp_drb is not None and ue.pdcp_drb is not None
    finally:
        epc.close()


# ------------------------------------------ analog of tests/test_ttcn3.py
def test_ss_attach_over_json_ports():
    servers = [JsonPort.listen() for _ in range(3)]
    testers = [JsonPort.connect("127.0.0.1", s.getsockname()[1]) for s in servers]
    ss_ports = [JsonPort.accept(s) for s in servers]
    ut, sys_p, srb = testers
    try:
        usim = SoftUsim(imsi="001010123456789", key=bytes(range(16)), opc=bytes(range(16, 32)))
        ue = UeApp(Cell(n_prb=25, id=1), UeNas(usim), device=CPU)
        ss = SystemSimulator(ue, ut=ss_ports[0], sys=ss_ports[1], srb=ss_ports[2])

        sys_p.send({"Common": {"CellId": "eutra_Cell1"},
                    "Request": {"Cell": {"AddOrReconfigure": {
                        "PhysicalCellId": 1, "Earfcn": 3400}}}})
        ss.handle_sys()
        assert sys_p.recv()["Confirm"]["Cell"] is True

        sys_p.send({"Request": {"EnquireTiming": True}})
        ss.handle_sys()
        t = sys_p.recv()
        assert "Time" in t and t["Confirm"]["EnquireTiming"] is True

        ut.send({"Cmd": {"MMI": {"Cmd": "SWITCH_ON"}}, "CnfRequired": True})
        ss.handle_ut()
        assert ut.recv()["Cnf"]["MMI"]["Result"] is True

        up = srb.recv()
        assert up["Common"]["RoutingInfo"]["RadioBearerId"]["Srb"] == 0
        req = rrc_unpack(bytes.fromhex(up["RrcPdu"]["Ccch"]), "ul_ccch")
        assert isinstance(req, ConnectionRequest)

        srb.send(srb_msg("eutra_Cell1", 0, "Ccch", rrc_pack(ConnectionSetup())))
        ss.handle_srb()

        up = srb.recv()
        assert up["Common"]["RoutingInfo"]["RadioBearerId"]["Srb"] == 1
        msg = rrc_unpack(bytes.fromhex(up["RrcPdu"]["Dcch"]), "ul_dcch")
        assert isinstance(msg, ConnectionSetupComplete)
        assert len(msg.nas_pdu) > 4
        assert ss.ue.state == "connected"
        assert ss.ue.rrc_state == "connected"
    finally:
        for p in testers + ss_ports:
            p.close()
        for s in servers:
            s.close()
