"""NB-IoT downlink parity: `srslte_tpu_torch.phy.nbiot` and the example pair
against the JAX package, on the CPU.

Analogs of tests/test_nbiot.py, tests/test_nbiot_data.py and
tests/test_nbiot_ue.py.  Inputs are made with numpy from a seed and handed
to both packages.  Grids that the encoders and the frame composer write are
equal within 1e-6 of their largest magnitude (the same float32 operations;
the Alamouti and OFDM sums in another order), time samples within 1e-5 of
theirs, channel estimates within 1e-5, and every hard output (offsets, cell
id, frame position, MIB, DCI, CRC flags, decoded bits) equal.  The JAX
package's Viterbi compiles once per code length.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.nbiot.npbch as j_npbch
import srslte_tpu.phy.nbiot.npdcch as j_npdcch
import srslte_tpu.phy.nbiot.npdsch as j_npdsch
import srslte_tpu.phy.nbiot.sync as j_sync
import srslte_tpu.phy.nbiot.ue as j_ue
import srslte_tpu_torch.phy.nbiot.npbch as t_npbch
import srslte_tpu_torch.phy.nbiot.npdcch as t_npdcch
import srslte_tpu_torch.phy.nbiot.npdsch as t_npdsch
import srslte_tpu_torch.phy.nbiot.sync as t_sync
import srslte_tpu_torch.phy.nbiot.ue as t_ue
from srslte_tpu_torch.examples import npdsch_enodeb, npdsch_ue

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores
N_ID = 257
RNTI = 0x2345
SF_LEN = 1920


@pytest.fixture(autouse=True, scope="module")
def _drop_xla_executables():
    """Drop the JAX package's compiled executables after this file: XLA on
    the CPU keeps each one mapped into the test worker, whose mappings are
    bounded (65,530), and the worker runs other files' tests after these."""
    yield
    jax.clear_caches()


def close(got, want, rel):
    """got (tensor) within rel of want's (JAX array's) largest magnitude."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30))


def cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


def chan(g, rng, h0=0.9 * np.exp(0.7j), n=0.02):
    """tests/test_nbiot_data.py:_chan on a host grid."""
    return (np.asarray(g) * h0 + cplx(rng, np.shape(g), n)).astype(np.complex64)


# ---------------------------------------------------------------- sync
def test_npss_detection():
    rng = np.random.default_rng(0)
    rep = t_sync.npss_time()
    x = cplx(rng, 6000, 0.1)
    x[1911 : 1911 + len(rep)] += 4.0 * rep
    jo, jm = j_sync.npss_find(jnp.asarray(x))
    to, tm = t_sync.npss_find(x, device=CPU)
    assert int(to) == int(jo) and abs(int(to) - 1911) <= 1
    assert float(tm) == pytest.approx(float(jm), rel=1e-4)
    # a batch of captures, each its own offset
    xs = np.stack([np.roll(x, k) for k in (0, 37, 500)])
    jo, _ = j_sync.npss_find(jnp.asarray(xs))
    to, _ = t_sync.npss_find(xs, device=CPU)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))


@pytest.mark.parametrize("nid,fpos", [(0, 0), (257, 3), (503, 1)])
def test_nsss_detection(nid, fpos):
    rng = np.random.default_rng(nid)
    rx = (t_sync.nsss_sequence(nid, fpos) * 0.8 * np.exp(0.7j) + cplx(rng, 132, 0.2)).astype(
        np.complex64)
    ji, jf, jm = j_sync.nsss_find(jnp.asarray(rx))
    ti, tf, tm = t_sync.nsss_find(rx, device=CPU)
    assert (int(ti), int(tf)) == (int(ji), int(jf)) == (nid, fpos)
    assert float(tm) == pytest.approx(float(jm), rel=1e-4)


# ---------------------------------------------------------------- OFDM, chest
def test_nb_ofdm_and_chest():
    rng = np.random.default_rng(1)
    g = cplx(rng, (3, 14, 12))
    close(t_ue.NbOfdm().tx_sf(g, device=CPU), j_ue.NbOfdm().tx_sf(jnp.asarray(g)), 1e-5)
    s = cplx(rng, (2, SF_LEN))
    close(t_ue.NbOfdm().rx_sf(s, device=CPU), j_ue.NbOfdm().rx_sf(jnp.asarray(s)), 1e-5)
    assert t_ue.NbOfdm().npss_offset == j_ue.NbOfdm().npss_offset
    for ports in (1, 2):
        jg = j_ue.NbEnbDl(N_ID, ports)._put_nrs(jnp.zeros((2, 14, 12), jnp.complex64), 3)
        tg = t_ue.NbEnbDl(N_ID, ports)._put_nrs(torch.zeros((2, 14, 12), dtype=torch.complex64),
                                                3)
        close(tg, jg, 0)
        h = np.array([0.8 * np.exp(0.9j), 0.5 * np.exp(-0.3j)], np.complex64)[:ports]
        rx = (np.asarray(jg)[:ports] * h[:, None, None]).sum(0) + cplx(rng, (14, 12), 0.01)
        (jce, jn), (tce, tn) = j_ue.nb_chest(jnp.asarray(rx), N_ID, 3), t_ue.nb_chest(
            rx, N_ID, 3, device=CPU)
        close(tce, jce, 1e-5)
        assert float(tn) == pytest.approx(float(jn), rel=1e-4)
        assert abs(complex(tce[0, 0, 0]) - h[0]) < 0.02


def test_cfo_correct_ramp():
    """The port forms the phase as the reference does (a float32 constant
    times a float32 ramp): over 4 frames (77,777 samples) the two corrections
    agree within 5e-7 of the signal's magnitude (the float32 cos and sin of
    two libraries), while a ramp formed in float64 and rounded once differs
    from the reference's by more than that at every CFO tried (up to 2.6e-5
    at -3517.25 Hz)."""
    rng = np.random.default_rng(2)
    x = cplx(rng, 4 * 19200 + 977)
    n = np.arange(len(x))
    for cfo in (120.0, -3517.25, 100.64507293701172):
        ref = np.asarray(j_ue.cfo_correct(jnp.asarray(x), cfo))
        close(t_ue.cfo_correct(x, cfo, device=CPU), ref, 5e-7)
        f64 = (x * np.exp(-2j * np.pi * cfo / 1920000 * n)).astype(np.complex64)
        assert np.abs(f64 - ref).max() > 5e-7 * np.abs(ref).max()


# ---------------------------------------------------------------- NPBCH
def test_npbch_tables_and_mib():
    for nid in (0, 17, N_ID):
        np.testing.assert_array_equal(t_npbch.npbch_re_indices(nid), j_npbch.npbch_re_indices(nid))
    mib = dict(sfn_msb=5, hyper_sfn_lsb=2, sched_info_sib1=3, sys_info_tag=7, ab_enabled=1,
               op_mode=2, spare=1234)
    bits = j_npbch.MibNb(**mib).pack()
    np.testing.assert_array_equal(t_npbch.MibNb(**mib).pack(), bits)
    assert t_npbch.MibNb.unpack(bits) == t_npbch.MibNb(**mib)
    for p in (1, 2):
        np.testing.assert_array_equal(t_npbch.crc_mask_nb(p), j_npbch.crc_mask_nb(p))
        np.testing.assert_array_equal(t_npbch.Npbch(N_ID, p)._codeword(t_npbch.MibNb(**mib)),
                                      j_npbch.Npbch(N_ID, p)._codeword(j_npbch.MibNb(**mib)))


@pytest.mark.parametrize("nof_ports,nf", [(1, 0), (1, 25), (2, 40), (2, 63)])
def test_npbch_roundtrip(nof_ports, nf):
    mib = dict(sfn_msb=5, sched_info_sib1=3, sys_info_tag=7, op_mode=2)
    jtx = j_npbch.Npbch(N_ID, nof_ports).encode_frame(j_npbch.MibNb(**mib), nf,
                                                      jnp.zeros((2, 14, 12), np.complex64))
    ttx = t_npbch.Npbch(N_ID, nof_ports).encode_frame(t_npbch.MibNb(**mib), nf,
                                                      torch.zeros((2, 14, 12), dtype=torch.complex64))
    close(ttx, jtx, 1e-6)
    rng = np.random.default_rng(nf)
    h = np.array([1.0, 0.8 * np.exp(1.2j)], np.complex64)
    rx = (h[:nof_ports, None, None] * np.asarray(jtx)[:nof_ports]).sum(0) + cplx(
        rng, (14, 12), 0.02)
    hh = h if nof_ports == 2 else np.array([h[0], 0], np.complex64)
    ce = np.broadcast_to(hh[:, None, None], (2, 14, 12)).astype(np.complex64)
    jok, jmib, jblock = j_npbch.Npbch(N_ID, 2).decode(jnp.asarray(rx), jnp.asarray(ce))
    tok, tmib, tblock = t_npbch.Npbch(N_ID, 2).decode(rx, ce, device=CPU)
    assert (tok, tblock) == (jok, jblock) == (True, (nf % 64) // 8)
    assert vars(tmib) == vars(jmib) == vars(t_npbch.MibNb(**mib))


# ---------------------------------------------------------------- NPDCCH
def test_dci_nb_codecs():
    rng = np.random.default_rng(3)
    for _ in range(16):
        n1 = dict(i_delay=int(rng.integers(8)), i_sf=int(rng.integers(8)),
                  i_mcs=int(rng.integers(16)), i_rep=int(rng.integers(16)),
                  ndi=int(rng.integers(2)), harq_ack=int(rng.integers(16)),
                  dci_rep=int(rng.integers(4)), order_ind=int(rng.integers(2)))
        bits = j_npdcch.pack_dci_n1(j_npdcch.DciN1(**n1))
        np.testing.assert_array_equal(t_npdcch.pack_dci_n1(t_npdcch.DciN1(**n1)), bits)
        assert vars(t_npdcch.unpack_dci_n1(bits)) == n1 and t_npdcch.unpack_dci_n0(bits) is None
        n0 = dict(sc_ind=int(rng.integers(64)), i_ru=int(rng.integers(8)),
                  i_delay=int(rng.integers(4)), i_mcs=int(rng.integers(16)),
                  rv=int(rng.integers(2)), i_rep=int(rng.integers(8)), ndi=int(rng.integers(2)),
                  dci_rep=int(rng.integers(4)))
        bits = j_npdcch.pack_dci_n0(j_npdcch.DciN0(**n0))
        np.testing.assert_array_equal(t_npdcch.pack_dci_n0(t_npdcch.DciN0(**n0)), bits)
        assert vars(t_npdcch.unpack_dci_n0(bits)) == n0 and t_npdcch.unpack_dci_n1(bits) is None


@pytest.mark.parametrize("ncce,fmt", [(0, 1), (0, 0), (1, 0)])
def test_npdcch_blind_search(ncce, fmt):
    d = dict(i_sf=2, i_mcs=6, ndi=1)
    jtx = j_npdcch.Npdcch(100, 4).encode(jnp.zeros((1, 14, 12), np.complex64),
                                         j_npdcch.pack_dci_n1(j_npdcch.DciN1(**d)), RNTI, ncce, fmt)
    ttx = t_npdcch.Npdcch(100, 4).encode(torch.zeros((1, 14, 12), dtype=torch.complex64),
                                         t_npdcch.pack_dci_n1(t_npdcch.DciN1(**d)), RNTI, ncce, fmt)
    close(ttx, jtx, 1e-6)
    rx = chan(jtx[0], np.random.default_rng(fmt * 2 + ncce))
    ce = np.full((1, 14, 12), 0.9 * np.exp(0.7j), np.complex64)
    for rnti in (RNTI, 0x1111):
        jhit = j_npdcch.Npdcch(100, 4).search(jnp.asarray(rx), jnp.asarray(ce), rnti)
        thit = t_npdcch.Npdcch(100, 4).search(rx, ce, rnti, device=CPU)
        if rnti == RNTI:
            assert thit[0] == jhit[0] == (ncce, fmt) and vars(thit[1]) == vars(jhit[1])
        else:
            assert thit is None and jhit is None


# ---------------------------------------------------------------- NPDSCH
def test_npdsch_tables():
    g = t_npdsch.NbDlGrant(i_tbs=12, i_sf=7)
    with pytest.raises(ValueError):
        _ = g.tbs
    for ports in (1, 2):
        np.testing.assert_array_equal(t_npdsch.npdsch_re_indices(N_ID, ports),
                                      j_npdsch.npdsch_re_indices(N_ID, ports))


@pytest.mark.parametrize("i_tbs,i_sf,ports", [(4, 0, 1), (9, 3, 1), (12, 2, 1), (4, 7, 2)])
def test_npdsch_multi_subframe(i_tbs, i_sf, ports):
    grant_kw = dict(i_tbs=i_tbs, i_sf=i_sf)
    jp = j_npdsch.Npdsch(100, j_npdsch.NbDlGrant(**grant_kw), RNTI, nof_ports=ports)
    tp = t_npdsch.Npdsch(100, t_npdsch.NbDlGrant(**grant_kw), RNTI, nof_ports=ports)
    nsf, tbs = jp.grant.nof_sf, jp.grant.tbs
    rng = np.random.default_rng(i_tbs)
    bits = rng.integers(0, 2, tbs).astype(np.uint8)
    sf_nf = tuple((4 + i, 10 + (4 + i) // 10) for i in range(nsf))
    jtx = jp.encode(jnp.asarray(bits), [jnp.zeros((2, 14, 12), np.complex64)] * nsf, sf_nf)
    ttx = tp.encode(torch.as_tensor(bits), [torch.zeros((2, 14, 12), dtype=torch.complex64)] * nsf,
                    sf_nf)
    for a, b in zip(ttx, jtx):
        close(a, b, 1e-6)
    h = np.array([0.85 * np.exp(0.5j), 0.6 * np.exp(-1.1j)], np.complex64)[:ports]
    rx = np.stack([(h[:, None, None] * np.asarray(t)[:ports]).sum(0) for t in jtx])
    rx = rx + cplx(rng, rx.shape, 0.3)
    ces = np.broadcast_to(np.pad(h, (0, 2 - ports))[None, :, None, None],
                          (nsf, 2, 14, 12)).astype(np.complex64)
    jout, jok = jp.decode(jnp.asarray(rx), jnp.asarray(ces), sf_nf)
    tout, tok = tp.decode(rx, ces, sf_nf, device=CPU)
    assert bool(tok) == bool(jok) is True
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    np.testing.assert_array_equal(tout.numpy(), bits)


# ---------------------------------------------------------------- the slice
def test_frame_grids_and_signal():
    """The frame composer's grids and samples, with an NPDCCH and a 2-subframe
    NPDSCH, for frames 0-3 (both NSSS parities) at 1 and 2 ports."""
    mib = dict(sfn_msb=5, sched_info_sib1=3, sys_info_tag=7, op_mode=2)
    grant = dict(i_tbs=5, i_sf=1)
    bits = np.random.default_rng(4).integers(0, 2, 144).astype(np.uint8)
    for ports in (1, 2):
        sf_nf = ((3, 1), (4, 1))
        jdata = j_npdsch.Npdsch(N_ID, j_npdsch.NbDlGrant(**grant), RNTI, ports).encode(
            jnp.asarray(bits), [jnp.zeros((2, 14, 12), np.complex64)] * 2, sf_nf)
        tdata = t_npdsch.Npdsch(N_ID, t_npdsch.NbDlGrant(**grant), RNTI, ports).encode(
            torch.as_tensor(bits), [torch.zeros((2, 14, 12), dtype=torch.complex64)] * 2, sf_nf)
        dci = dict(i_sf=1, i_mcs=5, ndi=1)
        for nf in range(4):
            jd = td = None
            if nf == 1:
                jd = {1: lambda g: j_npdcch.Npdcch(N_ID, 1).encode(
                    g, j_npdcch.pack_dci_n1(j_npdcch.DciN1(**dci)), RNTI),
                      3: lambda g: g + jdata[0], 4: lambda g: g + jdata[1]}
                td = {1: lambda g: t_npdcch.Npdcch(N_ID, 1).encode(
                    g, t_npdcch.pack_dci_n1(t_npdcch.DciN1(**dci)), RNTI),
                      3: lambda g: g + tdata[0], 4: lambda g: g + tdata[1]}
            jenb, tenb = j_ue.NbEnbDl(N_ID, ports), t_ue.NbEnbDl(N_ID, ports)
            close(tenb.frame_grids(t_npbch.MibNb(**mib), nf, td, device=CPU),
                  jenb.frame_grids(j_npbch.MibNb(**mib), nf, jd), 1e-6)
            close(tenb.frame_signal(t_npbch.MibNb(**mib), nf, td, device=CPU),
                  jenb.frame_signal(j_npbch.MibNb(**mib), nf, jd), 1e-5)


def test_example_pair():
    """The port's example pair against the JAX package's on one capture: the
    port's transmitter equal (within 1e-5 of the magnitude) to the JAX one;
    the capture impaired as tests/test_nbiot_ue.py:_impair does (delay 1234,
    CFO 120 Hz, 12 dB); both receivers find the same cell, CFO (within
    0.05 Hz), MIB, DCI and NPDSCH bits, which equal those sent.  Then the
    port's pair from the command line through a file, and the sync's
    `track` and the MIB loop on the same capture."""
    import importlib.util
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent

    def example(name):
        spec = importlib.util.spec_from_file_location(name, root / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    frames = 4
    sig_j = example("npdsch_enodeb").generate(N_ID, RNTI, frames, 5, 1)
    sig_t = npdsch_enodeb.generate(N_ID, RNTI, frames, 5, 1, device=CPU)
    close(sig_t, sig_j, 1e-5)
    rng = np.random.default_rng(1)
    n = np.arange(len(sig_t))
    x = sig_t * np.exp(2j * np.pi * 120.0 * n / 1.92e6)
    p = np.mean(np.abs(x[np.abs(x) > 0]) ** 2)
    out = cplx(rng, len(x) + 1234, np.sqrt(p / 10 ** 1.2 / 2))
    out[1234:] += x.astype(np.complex64)
    jr = example("npdsch_ue").receive(out, RNTI)
    tr = npdsch_ue.receive(out, RNTI, device=CPU)
    for k in ("n_id", "frame_pos", "sf0_offset"):
        assert tr["cell"][k] == jr["cell"][k]
    assert tr["cell"]["n_id"] == N_ID and (tr["cell"]["sf0_offset"] - 1234) % (20 * SF_LEN) <= 1
    assert tr["cell"]["cfo_hz"] == pytest.approx(jr["cell"]["cfo_hz"], abs=0.05)
    assert vars(tr["mib"]) == vars(jr["mib"])
    assert len(tr["results"]) == len(jr["results"]) == 1
    for a, b in zip(tr["results"], jr["results"]):
        assert (a["frame"], a["tbs"], a["crc_ok"]) == (b["frame"], b["tbs"], b["crc_ok"]) == \
            (1, 144, True)
        np.testing.assert_array_equal(a["bits"], np.asarray(b["bits"]))
        np.testing.assert_array_equal(a["bits"], np.random.default_rng(0).integers(0, 2, 144))
    # the sync's track at the found NPSS, and the MIB loop over subframe 0s
    jsync, tsync = j_ue.UeSyncNbiot(), t_ue.UeSyncNbiot()
    npss = 1234 + 5 * SF_LEN + t_ue.NbOfdm().npss_offset + 3
    jd, jm = jsync.track(jnp.asarray(out), npss)
    td, tm = tsync.track(out, npss, device=CPU)
    assert td == jd and tm == pytest.approx(jm, rel=1e-4)
    x = t_ue.cfo_correct(out, tr["cell"]["cfo_hz"], device=CPU).numpy()
    sf0s = np.stack([x[1234 + f * 19200 : 1234 + f * 19200 + SF_LEN] for f in range(frames)])
    jm = j_ue.UeMibNbiot(N_ID).decode(jnp.asarray(sf0s))
    tm = t_ue.UeMibNbiot(N_ID).decode(sf0s, device=CPU)
    assert tm[0] and (tm[2], tm[3]) == (jm[2], jm[3]) and vars(tm[1]) == vars(jm[1])


def test_example_pair_command_line(tmp_path, capsys):
    """The port's pair as `python -m ...` runs it, on the CPU, through a file."""
    path = str(tmp_path / "nb.bin")
    npdsch_enodeb.main([path, "--frames", "4", "--device", "cpu"])
    with pytest.raises(SystemExit) as e:
        npdsch_ue.main([path, "--device", "cpu"])
    assert e.value.code == 0
    assert "1 NPDSCH transport block(s) decoded" in capsys.readouterr().out
