"""The full-stack eNB and UE of the port over the air, on the CPU.

`srslte_tpu_torch.enb.EnbApp` and `srslte_tpu_torch.ue.UeApp` exchange real
PHY subframes TTI by TTI, as tests/test_e2e_stack.py drives the JAX
package's: MIB -> PRACH/RAR/msg3/msg4 -> RRC connection -> NAS attach with
Milenage AKA and NAS security -> AS security and DRB setup -> ciphered user
plane both ways, with HARQ-ACK on PUCCH 1a or on PUSCH.

- The lockstep tests run the JAX apps and the port's side by side on
  `Cell(n_prb=6)`, with the random inputs pinned (the HSS's RAND through
  `os.urandom`, the UE's ConnectionRequest identity through `identity=`):
  at every TTI the DL and the UL samples agree to 1e-5 of their RMS, the
  MAC PDUs each side decoded are equal byte for byte, and so are the UE's
  and the eNB's states.  Tier 1 runs it to TTI 35 (RRC connected); the
  whole attach and data (76 TTIs, most of it the JAX package compiling each
  new shape) is marked slow, as the reference marks its own full-stack
  tests.
- The other tests are the analogs of tests/test_e2e_stack.py,
  tests/test_multi_ue.py, tests/test_harq_feedback.py, tests/test_sib2.py,
  tests/test_e2e_tdd.py, tests/test_mobility.py and tests/test_reselection.py
  on the port alone, with every assertion of the reference's, at 6 PRB
  where the reference runs 15.
"""

import os

import numpy as np
import pytest
import torch

from srslte_tpu_torch.enb import EnbApp
from srslte_tpu_torch.epc import Hss, Mme, Spgw
from srslte_tpu_torch.phy.common.params import Cell
from srslte_tpu_torch.phy.common.tdd import SfType
from srslte_tpu_torch.phy.phch.pdsch import Pdsch
from srslte_tpu_torch.rrc.messages import Sib2
from srslte_tpu_torch.security.milenage import compute_opc
from srslte_tpu_torch.ue import UeApp
from srslte_tpu_torch.ue_stack import SoftUsim, UeNas

IMSI = "001010123456789"
K = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
K2 = bytes.fromhex("fec86ba6eb707ed08905757b1bb44b8f")
OP = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
CPU = "cpu"
N_PRB = 6
SAMPLES_REL_TOL = 1e-5  # max |port - JAX| over the RMS of the JAX subframe
PCI_A, PCI_B = 42, 45

torch.set_num_threads(1)  # several test workers share the machine's cores


def network(cell, subscribers=((IMSI, K),), **enb_kw):
    hss = Hss()
    for imsi, k in subscribers:
        hss.add_subscriber(imsi, k, op=OP)
    mme = Mme(hss, Spgw())
    return mme, EnbApp(cell, mme=mme, device=CPU, **enb_kw)


def ue_app(cell, imsi=IMSI, k=K, **kw):
    return UeApp(cell, UeNas(SoftUsim(imsi, k, compute_opc(k, OP))), device=CPU, **kw)


# ----------------------------------------------------------------- lockstep
def lockstep(n_tti):
    """The JAX apps and the port's side by side for at most n_tti TTIs (the
    data phase starts after the attach); returns the port's UE, eNB and the
    last TTI run."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    import srslte_tpu.enb as j_enb
    import srslte_tpu.epc as j_epc
    import srslte_tpu.phy.common.params as j_params
    import srslte_tpu.security.milenage as j_mil
    import srslte_tpu.ue as j_ue
    import srslte_tpu.ue_stack as j_us

    hss = j_epc.Hss()
    hss.add_subscriber(IMSI, K, op=OP)
    j_mme = j_epc.Mme(hss, j_epc.Spgw())
    jc = j_params.Cell(n_prb=N_PRB, id=42, nof_ports=1)
    je = j_enb.EnbApp(jc, mme=j_mme)
    ju = j_ue.UeApp(jc, j_us.UeNas(j_us.SoftUsim(IMSI, K, j_mil.compute_opc(K, OP))))
    # the identity the JAX UeApp draws from id(self), given to the port's
    ident = np.random.default_rng(id(ju) & 0xFFFF).integers(0, 256, 4).astype(np.uint8).tobytes()
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    mme, te = network(cell)
    tu = ue_app(cell, identity=ident)

    logs = {"jax": [], "port": []}

    def record(log, fn, kind):
        def call(*args):
            log.append((kind,) + tuple(a for a in args if isinstance(a, (bytes, int))))
            return fn(*args)
        return call

    for key, ue, enb in (("jax", ju, je), ("port", tu, te)):
        ue._handle_dlsch = record(logs[key], ue._handle_dlsch, "dl")
        enb._handle_msg3 = record(logs[key], enb._handle_msg3, "msg3")
        enb._handle_ul_mac = record(logs[key], enb._handle_ul_mac, "ul")

    def assert_close(j, t, what, tti):
        assert (j is None) == (t is None), f"TTI {tti}: {what} sent by one package only"
        if j is None:
            return
        j = np.asarray(j)
        t = t.numpy()
        assert t.shape == j.shape and t.dtype == np.complex64
        rms = np.sqrt(np.mean(np.abs(j) ** 2))
        err = np.abs(t - j).max() / rms
        assert err <= SAMPLES_REL_TOL, f"TTI {tti}: {what} differ by {err:.3g} of the RMS"

    def states(ue, enb):
        return (ue.state, ue.rrc_state, ue.nas.state, ue.crnti, ue.ra.state,
                sorted((c, u.rrc_state) for c, u in enb.ues.items()))

    sent = False
    for tti in range(n_tti):
        jd, td = je.tx_subframe(tti), te.tx_subframe(tti)
        assert_close(jd, td, "DL samples", tti)
        ju.rx_subframe(jd, tti)
        tu.rx_subframe(td, tti)
        ju_ul, tu_ul = ju.tx_subframe(tti), tu.tx_subframe(tti)
        assert_close(ju_ul, tu_ul, "UL samples", tti)
        je.rx_subframe(ju_ul, tti)
        te.rx_subframe(tu_ul, tti)
        assert logs["port"] == logs["jax"], f"TTI {tti}: decoded MAC PDUs differ"
        assert states(tu, te) == states(ju, je), f"TTI {tti}: states differ"
        if ju.nas.state == "attached" and ju.pdcp_drb is not None and not sent:
            for ue, enb in ((ju, je), (tu, te)):
                ue.send_data(b"uplink-ping")
                enb.send_data(ue.crnti, b"downlink-pong")
            sent = True
        if sent and ju.rx_data and je.ues[ju.crnti].rx_data:
            assert tu.rx_data == ju.rx_data
            assert te.ues[tu.crnti].rx_data == je.ues[ju.crnti].rx_data
            break
    return tu, te, tti


def test_lockstep_to_rrc_connection(monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) & 0xFF for i in range(n)))
    ue, enb, _ = lockstep(36)
    assert ue.mib is not None and ue.sib1 is not None and ue.sib2 is not None
    assert ue.state == "connected" and ue.rrc_state == "connected"
    assert enb.ues[ue.crnti].rrc_state == "connected"


@pytest.mark.slow
def test_lockstep_attach_and_data(monkeypatch):
    monkeypatch.setattr(os, "urandom", lambda n: bytes((7 * i + 3) & 0xFF for i in range(n)))
    ue, enb, tti = lockstep(160)
    assert ue.nas.state == "attached"
    assert ue.rx_data == [b"downlink-pong"]
    assert enb.ues[ue.crnti].rx_data == [b"uplink-ping"]


# ------------------------------------------------- the device and the wire
@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the machine without a card")
def test_apps_default_to_the_card():
    """device=None means the CUDA device: without one the apps raise."""
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        EnbApp(cell, mme=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        UeApp(cell, UeNas(SoftUsim(IMSI, K, compute_opc(K, OP))))


def test_s1_wire_path_is_step_6b():
    with pytest.raises(NotImplementedError, match="step 6b"):
        EnbApp(Cell(n_prb=N_PRB, id=42, nof_ports=1), s1={}, device=CPU)


# -------------------------------------- analogs of tests/test_e2e_stack.py
def test_full_stack_attach_and_data_over_the_air():
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    mme, enb = network(cell)
    ue = ue_app(cell)

    data_sent = False
    for tti in range(160):
        dl = enb.tx_subframe(tti)
        assert dl.device.type == "cpu" and dl.dtype == torch.complex64
        ue.rx_subframe(dl, tti)
        ul = ue.tx_subframe(tti)
        enb.rx_subframe(ul, tti)
        if ue.nas.state == "attached" and ue.pdcp_drb is not None and not data_sent:
            ue.send_data(b"uplink-ping")
            enb.send_data(ue.crnti, b"downlink-pong")
            data_sent = True
        if data_sent and ue.rx_data and enb.ues[ue.crnti].rx_data:
            break

    assert ue.mib is not None, "MIB never decoded"
    assert ue.state == "connected", f"RA failed: {ue.ra.state}"
    assert ue.nas.state == "attached", f"NAS state: {ue.nas.state}"
    assert ue.nas.ip.startswith("172.16.0.")
    assert ue.sib1 is not None, "SIB1 never received"
    ectx = mme.ues[enb.ues[ue.crnti].ue_id]
    assert ue.nas.sec.k_int == ectx.sec.k_int
    assert enb.ues[ue.crnti].rx_data == [b"uplink-ping"]
    assert ue.rx_data == [b"downlink-pong"]


def test_release_page_and_reconnect_over_the_air():
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    mme, enb = network(cell)
    ue = ue_app(cell)

    released = paged = False
    for tti in range(400):
        dl = enb.tx_subframe(tti)
        ue.rx_subframe(dl, tti)
        ul = ue.tx_subframe(tti)
        enb.rx_subframe(ul, tti)
        if ue.nas.state == "attached" and not released and ue.crnti:
            ctx = enb.ues.get(ue.crnti)
            if ctx is not None and ctx.rrc_state in ("secure", "rrc_reconfigured"):
                enb.release_connection(ctx)
                released = True
                old_crnti = ue.crnti
        if released and ue.state == "camped" and not paged:
            enb.release_ue(enb.ues[old_crnti])
            enb.page(ue.nas.guti)
            paged = True
        if paged and ue.paged and ue.state == "connected":
            break

    assert released, "release never sent"
    assert ue.paged >= 1, "paging never received"
    assert ue.state == "connected", f"no reconnect: {ue.state}/{ue.ra.state}"
    assert ue.crnti and ue.crnti in enb.ues


# ---------------------------------------- analog of tests/test_multi_ue.py
def test_two_ues_attach_and_data_over_the_air():
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    mme, enb = network(cell, ((IMSI, K), ("001010000000001", K2)))
    ue1 = ue_app(cell)
    ue2 = ue_app(cell, "001010000000001", K2)
    UE2_START = 80  # stagger so the PRACH/msg3 occasions never superpose

    sent = {1: False, 2: False}
    for tti in range(500):
        dl = enb.tx_subframe(tti)
        ue1.rx_subframe(dl, tti)
        if tti >= UE2_START:
            ue2.rx_subframe(dl, tti)
        ul1 = ue1.tx_subframe(tti)
        ul2 = ue2.tx_subframe(tti) if tti >= UE2_START else None
        if ul1 is not None and ul2 is not None:
            ul = ul1 + ul2  # superposition on the air
        else:
            ul = ul1 if ul1 is not None else ul2
        enb.rx_subframe(ul, tti)
        for i, ue in ((1, ue1), (2, ue2)):
            if ue.nas.state == "attached" and ue.pdcp_drb is not None and not sent[i]:
                ue.send_data(f"ul-ping-{i}".encode())
                enb.send_data(ue.crnti, f"dl-pong-{i}".encode())
                sent[i] = True
        if (sent[1] and sent[2] and ue1.rx_data and ue2.rx_data
                and enb.ues[ue1.crnti].rx_data and enb.ues[ue2.crnti].rx_data):
            break

    assert ue1.nas.state == "attached", f"UE1 NAS: {ue1.nas.state}"
    assert ue2.nas.state == "attached", f"UE2 NAS: {ue2.nas.state}"
    assert ue1.crnti != ue2.crnti
    assert enb.ues[ue1.crnti].rx_data == [b"ul-ping-1"]
    assert enb.ues[ue2.crnti].rx_data == [b"ul-ping-2"]
    assert ue1.rx_data == [b"dl-pong-1"]
    assert ue2.rx_data == [b"dl-pong-2"]


# ---------------------------------- analogs of tests/test_harq_feedback.py
def test_nack_triggers_pucch_and_retransmission(monkeypatch):
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    mme, enb = network(cell)
    ue = ue_app(cell)
    cc = enb.ccs[cell.id]

    real_decode = Pdsch.decode
    corrupt = {"on": False}

    def flaky_decode(self, grid, ce, noise, **kw):
        bits, ok = real_decode(self, grid, ce, noise, **kw)
        if corrupt["on"]:
            return bits, torch.tensor(False)  # force a TB CRC failure
        return bits, ok

    monkeypatch.setattr(Pdsch, "decode", flaky_decode)

    data_sent = nacked = retxed = False
    for tti in range(300):
        dl = enb.tx_subframe(tti)
        ue.rx_subframe(dl, tti)
        if ue.pending_ack.get(tti + 4, (None, None))[1] == 0:
            nacked = True
        ul = ue.tx_subframe(tti)
        enb.rx_subframe(ul, tti)
        if cc.dl_retx:
            retxed = True
        if ue.nas.state == "attached" and ue.pdcp_drb is not None and not data_sent:
            corrupt["on"] = True  # corrupt exactly the next DL data TB the UE receives
            enb.send_data(ue.crnti, b"harq-payload")
            data_sent = True
        if nacked and corrupt["on"]:
            corrupt["on"] = False  # one NACK is enough; let the retx decode
        if data_sent and ue.rx_data:
            break

    assert ue.nas.state == "attached"
    assert nacked, "forced CRC failure never produced a NACK"
    assert retxed, "eNB never queued a retransmission for the NACK"
    assert ue.rx_data == [b"harq-payload"], "retransmission not delivered"


def test_clean_channel_acks_no_spurious_retx():
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    mme, enb = network(cell)
    ue = ue_app(cell)
    cc = enb.ccs[cell.id]

    data_sent = saw_ack_tx = False
    retx_events = 0
    for tti in range(200):
        dl = enb.tx_subframe(tti)
        ue.rx_subframe(dl, tti)
        if ue.pending_ack:
            saw_ack_tx = True
        ul = ue.tx_subframe(tti)
        enb.rx_subframe(ul, tti)
        retx_events += len(cc.dl_retx)
        if ue.nas.state == "attached" and ue.pdcp_drb is not None and not data_sent:
            enb.send_data(ue.crnti, b"pong")
            data_sent = True
        if data_sent and ue.rx_data:
            break

    assert ue.rx_data == [b"pong"]
    assert saw_ack_tx, "UE never armed HARQ feedback"
    assert retx_events == 0, "clean channel must not retransmit"


# ---------------------------------------------- analogs of tests/test_sib2.py
def test_attach_with_nondefault_sib2():
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    sib2 = Sib2(root_seq_idx=6, zero_corr_cfg=5, n1_pucch_an=24)
    mme, enb = network(cell, sib2=sib2)
    ue = ue_app(cell)

    data_sent = False
    for tti in range(260):
        dl = enb.tx_subframe(tti)
        ue.rx_subframe(dl, tti)
        ul = ue.tx_subframe(tti)
        enb.rx_subframe(ul, tti)
        if ue.nas.state == "attached" and ue.pdcp_drb is not None and not data_sent:
            enb.send_data(ue.crnti, b"sib2-pong")
            data_sent = True
        if data_sent and ue.rx_data:
            break

    assert ue.sib2 == sib2
    assert ue.n_pucch_1 == 24
    assert ue.prach_cfg.zero_corr_cfg == 5
    assert ue.prach_cfg.root_seq_idx == 6
    assert ue.nas.state == "attached"
    assert ue.rx_data == [b"sib2-pong"]


def test_prach_config_index_moves_the_opportunity():
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1)
    mme, enb = network(cell, sib2=Sib2(prach_cfg_idx=4))
    ue = ue_app(cell)
    assert enb._prach_sf() == 4

    prach_ttis = []
    for tti in range(260):
        dl = enb.tx_subframe(tti)
        ue.rx_subframe(dl, tti)
        pending = {t: v.kind for t, v in ue.pending_ul.items()}
        ul = ue.tx_subframe(tti)
        if pending.get(tti) == "prach":
            prach_ttis.append(tti)
        enb.rx_subframe(ul, tti)
        if ue.nas.state == "attached":
            break

    assert ue.nas.state == "attached"
    assert prach_ttis and all(t % 10 == 4 for t in prach_ttis), prach_ttis


# ------------------------------------------ analog of tests/test_e2e_tdd.py
def test_tdd_full_stack_attach_and_data():
    cell = Cell(n_prb=N_PRB, id=42, nof_ports=1, frame_type="tdd")
    mme, enb = network(cell)
    ue = ue_app(cell)
    tdd = enb.tdd
    assert tdd is not None and ue.tdd == tdd

    data_sent = False
    for tti in range(240):
        dl = enb.tx_subframe(tti)
        assert (dl is not None) == (tdd.sf_type(tti % 10) is not SfType.UL)
        ue.rx_subframe(dl, tti)
        ul = ue.tx_subframe(tti)
        if ul is not None:
            assert tdd.sf_type(tti % 10) is SfType.UL
        enb.rx_subframe(ul, tti)
        if ue.nas.state == "attached" and ue.pdcp_drb is not None and not data_sent:
            ue.send_data(b"tdd-uplink-ping")
            enb.send_data(ue.crnti, b"tdd-downlink-pong")
            data_sent = True
        if data_sent and ue.rx_data and enb.ues[ue.crnti].rx_data:
            break

    assert ue.mib is not None, "MIB never decoded"
    assert ue.state == "connected", f"RA failed: {ue.ra.state}"
    assert ue.nas.state == "attached", f"NAS state: {ue.nas.state}"
    assert enb.ues[ue.crnti].rx_data == [b"tdd-uplink-ping"]
    assert ue.rx_data == [b"tdd-downlink-pong"]


# ------------ analogs of tests/test_mobility.py and tests/test_reselection.py
def two_cells():
    cells = [Cell(n_prb=N_PRB, id=PCI_A, nof_ports=1), Cell(n_prb=N_PRB, id=PCI_B, nof_ports=1)]
    mme, enb = network(cells)
    return enb, ue_app(cells[0], neighbor_pcis=(PCI_B,))


def two_cell_step(enb, ue, tti, ga, gb, sigma=0.0, gen=None):
    """One TTI of two-cell virtual RF: the DL sum with per-cell gains (and
    AWGN of std sigma), the UL routed to the UE's serving cell."""
    dl = ga * enb.tx_subframe(tti, pci=PCI_A) + gb * enb.tx_subframe(tti, pci=PCI_B)
    if sigma > 0.0:
        dl = dl + sigma * torch.randn(dl.shape, dtype=torch.complex64, generator=gen)
    ue.rx_subframe(dl, tti)
    ul = ue.tx_subframe(tti)
    for pci in (PCI_A, PCI_B):
        enb.rx_subframe(ul if (ul is not None and pci == ue.cell.id) else None, tti, pci=pci)


def attach_on_a(enb, ue, sigma=0.0, gen=None):
    tti = 0
    while tti < 300 and ue.nas.state != "attached":
        two_cell_step(enb, ue, tti, 1.0, 0.05, sigma, gen)
        tti += 1
    for _ in range(30):  # settle until the DRB reconfiguration completes
        two_cell_step(enb, ue, tti, 1.0, 0.05, sigma, gen)
        tti += 1
    assert ue.nas.state == "attached", f"attach failed: {ue.nas.state}"
    assert ue.cell.id == PCI_A
    return tti


def test_a3_handover_with_data_continuity():
    enb, ue = two_cells()
    tti = attach_on_a(enb, ue)

    ue.send_data(b"ping-on-A")
    enb.send_data(ue.crnti, b"pong-on-A")
    for _ in range(60):
        two_cell_step(enb, ue, tti, 1.0, 0.05)
        tti += 1
        if ue.rx_data and enb.ues[ue.crnti].rx_data:
            break
    assert enb.ues[ue.crnti].rx_data == [b"ping-on-A"]
    assert ue.rx_data == [b"pong-on-A"]
    assert ue.meas_engine is not None, "measConfig never applied"
    old_crnti = ue.crnti

    # neighbour B comes up 8 dB above serving A -> A3 -> handover
    deadline = tti + 150
    while tti < deadline and ue.ho_count == 0:
        two_cell_step(enb, ue, tti, 0.4, 1.0)
        tti += 1
    for _ in range(20):  # let ReconfigurationComplete land on the target
        two_cell_step(enb, ue, tti, 0.4, 1.0)
        tti += 1
    assert ue.ho_count == 1, "handover never executed"
    assert ue.cell.id == PCI_B
    assert ue.crnti != old_crnti
    ectx = enb.ues[ue.crnti]
    assert ectx.pci == PCI_B and not ectx.ho_pending
    assert old_crnti not in enb.ues, "stale source C-RNTI context"

    ue.send_data(b"ping-on-B")
    enb.send_data(ue.crnti, b"pong-on-B")
    for _ in range(80):
        two_cell_step(enb, ue, tti, 0.05, 1.0)
        tti += 1
        if len(ue.rx_data) > 1 and len(ectx.rx_data) > 1:
            break
    assert ectx.rx_data == [b"ping-on-A", b"ping-on-B"]
    assert ue.rx_data == [b"pong-on-A", b"pong-on-B"]


def test_rlf_reestablishment_on_neighbor_cell():
    gen = torch.Generator().manual_seed(7)
    sigma = 0.05  # AWGN floor so a collapsed serving cell really reads < -3 dB
    enb, ue = two_cells()
    tti = attach_on_a(enb, ue, sigma, gen)
    old_crnti = ue.crnti

    deadline = tti + 250
    while tti < deadline and ue.reest_count == 0:
        two_cell_step(enb, ue, tti, 0.02, 1.0, sigma, gen)
        tti += 1
    for _ in range(40):  # drain complete + DRB re-add reconfiguration
        two_cell_step(enb, ue, tti, 0.02, 1.0, sigma, gen)
        tti += 1
    assert ue.rlm.rlf or ue.reest_count, "RLF never declared"
    assert ue.reest_count == 1, "reestablishment never completed"
    assert ue.cell.id == PCI_B
    assert ue.crnti != old_crnti
    ectx = enb.ues[ue.crnti]
    assert ectx.pci == PCI_B

    ue.send_data(b"back-from-the-dead")
    enb.send_data(ue.crnti, b"welcome-back")
    for _ in range(80):
        two_cell_step(enb, ue, tti, 0.02, 1.0, sigma, gen)
        tti += 1
        if ue.rx_data and ectx.rx_data:
            break
    assert ectx.rx_data == [b"back-from-the-dead"]
    assert ue.rx_data == [b"welcome-back"]


def test_idle_reselection_then_page_on_new_cell():
    enb, ue = two_cells()
    tti = 0
    while tti < 300 and ue.nas.state != "attached":
        two_cell_step(enb, ue, tti, 1.0, 0.05)
        tti += 1
    assert ue.nas.state == "attached"
    crnti = ue.crnti

    enb.release_connection(enb.ues[crnti])
    while tti < 500 and ue.state != "camped":
        two_cell_step(enb, ue, tti, 1.0, 0.05)
        tti += 1
    assert ue.state == "camped" and ue.rrc_state == "idle"
    assert ue.cell.id == PCI_A

    t0 = tti
    while tti < t0 + 300 and ue.reselect_count == 0:
        two_cell_step(enb, ue, tti, 0.05, 1.0)
        tti += 1
    assert ue.reselect_count == 1, "UE never reselected to the stronger cell"
    assert ue.cell.id == PCI_B
    assert ue.state == "camped"

    enb.page(ue.nas.guti)
    t0 = tti
    while tti < t0 + 400 and ue.state != "connected":
        two_cell_step(enb, ue, tti, 0.05, 1.0)
        tti += 1
    assert ue.paged >= 1, "page never reached the reselected UE"
    assert ue.state == "connected"
    assert ue.cell.id == PCI_B
    assert enb.ues[ue.crnti].pci == PCI_B
