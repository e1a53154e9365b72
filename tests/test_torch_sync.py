"""The sync family of the blind receiver against the JAX package, on the CPU.

PSS search and CFO, SSS detection, the CP CFO estimator, `sync_find` for
FDD, TDD and "auto", cell search, the CRS finder, the SFO fit, and
`UeSync.find` with three `track_block`s: the same numpy inputs (signals and
noise from seeds) go through both packages.

Tolerances.  Hard outputs (roots, offsets, cell ids, sf5, subframe indices,
stream positions) are equal.  Floats agree to rtol 1e-4 and atol 1e-5 of
the signal's scale (float32 FFTs and sums in another order), except the
normalized PSS metric: it divides by the difference of two float32
cumulative sums over the whole window, which PyTorch and XLA sum in
different orders, so it is held to rtol 1e-3 and its argmax (root and
offset) only where the peak is clear, as here.  The tracked CFO accumulates
the CP estimates of three blocks and is held to atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.sync.cfo as j_cfo
import srslte_tpu.phy.sync.pss as j_pss
import srslte_tpu.phy.sync.refsignal_sync as j_rss
import srslte_tpu.phy.sync.sfo as j_sfo
import srslte_tpu.phy.sync.sss as j_sss
import srslte_tpu.phy.sync.sync as j_sync
import srslte_tpu.phy.ue.ue_cell_search as j_cs
import srslte_tpu.phy.ue.ue_sync as j_ues
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.sync.cfo as t_cfo
import srslte_tpu_torch.phy.sync.pss as t_pss
import srslte_tpu_torch.phy.sync.refsignal_sync as t_rss
import srslte_tpu_torch.phy.sync.sfo as t_sfo
import srslte_tpu_torch.phy.sync.sss as t_sss
import srslte_tpu_torch.phy.sync.sync as t_sync
import srslte_tpu_torch.phy.ue.ue_cell_search as t_cs
import srslte_tpu_torch.phy.ue.ue_sync as t_ues
from srslte_tpu_torch.phy.enb.enb_dl import EnbDl

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


def close(got, ref, rtol=1e-4, scale=None):
    """rtol, and atol 1e-5 of the signal's scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-5 * scale)


def eq(got, ref):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(ref))


def frame(n_prb, cell_id, frame_type="fdd", n_sf=10):
    """Subframes 0..n_sf-1 of a cell's CRS + PSS/SSS signal (port 0), numpy."""
    cell = t_params.Cell(n_prb=n_prb, id=cell_id, frame_type=frame_type)
    enb = EnbDl(cell)
    sfs = [enb.gen_signal(enb.put_base(enb.empty_grids(device=CPU), sf))[0] for sf in range(n_sf)]
    return torch.cat(sfs).numpy()


def impair(x, delay, cfo, sigma, seed, fft_size):
    """Delay (zeros first), CFO in subcarriers, complex AWGN of std sigma per part."""
    rng = np.random.default_rng(seed)
    x = np.concatenate([np.zeros(delay, np.complex64), x])
    x = x * np.exp(2j * np.pi * cfo * np.arange(len(x)) / fft_size)
    x = x + sigma * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    return x.astype(np.complex64)


def both_ofdm(n_prb, cp="norm"):
    return (j_params.OfdmParams(n_prb, j_params.CP(cp)),
            t_params.OfdmParams(n_prb, t_params.CP(cp)))


# ------------------------------------------------------------ window_slice
def test_window_slice_places_starts_as_dynamic_slice():
    """Every start the receivers can pass (negative, inside, past the end)
    lands where `lax.dynamic_slice_in_dim` puts it."""
    from jax import lax

    x = np.arange(40, dtype=np.float32).reshape(2, 20)
    for start in (-30, -20, -7, -1, 0, 3, 14, 15, 19, 25):
        ref = np.asarray(lax.dynamic_slice_in_dim(jnp.asarray(x), start, 6, axis=-1))
        eq(t_sync.window_slice(torch.as_tensor(x), start, 6), ref)
    starts = torch.tensor([-3, 17])  # one start per row
    eq(t_sync.window_slice(torch.as_tensor(x), starts, 6), np.stack(
        [np.asarray(lax.dynamic_slice_in_dim(jnp.asarray(x[i]), int(s), 6)) for i, s in enumerate(starts)]))


# -------------------------------------------------------------------- PSS
def pss_windows(n=128, L=1500):
    """Windows with one PSS each: at the very start, inside, and at the very
    end (offset L - n), over noise; rows' roots 0, 1, 2, 1."""
    rng = np.random.default_rng(0)
    x = 0.05 * (rng.standard_normal((4, L)) + 1j * rng.standard_normal((4, L)))
    cases = ((0, 0), (1, 333), (2, 777), (1, L - n))
    for i, (nid2, off) in enumerate(cases):
        x[i, off : off + n] += 3.0 * j_pss.pss_time(nid2, n)
    return x.astype(np.complex64), cases


def test_pss_find_and_peak():
    x, cases = pss_windows()
    for norm in (True, False):
        ref = np.asarray(j_pss.pss_find(jnp.asarray(x), 128, norm=norm))
        got = t_pss.pss_find(x, 128, norm=norm, device=CPU)
        close(got, ref, rtol=1e-3 if norm else 1e-4)
    jn, jo, jm = j_pss.pss_find_peak(jnp.asarray(x), 128)
    tn, to, tm = t_pss.pss_find_peak(x, 128, device=CPU)
    eq(tn, jn)
    eq(to, jo)
    eq(tn, [c[0] for c in cases])
    eq(to, [c[1] for c in cases])
    close(tm, jm, rtol=1e-3)


def test_pss_cfo_compute():
    n = 128
    cfos = np.array([-0.7, -0.1, 0.25, 1.2])
    nid2 = np.array([0, 1, 2, 1])
    x = np.stack([j_pss.pss_time(int(u), n) * np.exp(2j * np.pi * c * np.arange(n) / n)
                  for u, c in zip(nid2, cfos)]).astype(np.complex64)
    ref = np.stack([np.asarray(j_pss.pss_cfo_compute(jnp.asarray(x[i]), jnp.int32(nid2[i]), n))
                    for i in range(4)])
    got = t_pss.pss_cfo_compute(x, torch.as_tensor(nid2), n, device=CPU)
    close(got, ref, scale=1.0)
    # a plain int root, as the reference also takes
    close(t_pss.pss_cfo_compute(x[1], 1, n, device=CPU), ref[1], scale=1.0)


# -------------------------------------------------------------------- SSS
@pytest.mark.parametrize("n_id_1,n_id_2,sf5", [(0, 0, False), (167, 2, True), (84, 1, False),
                                               (25, 2, True), (101, 0, True)])
def test_sss_find(n_id_1, n_id_2, sf5):
    rng = np.random.default_rng(n_id_1)
    d = j_sss.sss_sequence(n_id_1, n_id_2, sf5).astype(np.complex64)
    ramp = np.exp(2j * np.pi * 0.002 * np.arange(62))
    rows = np.stack([d, d * ramp + 0.3 * (rng.standard_normal(62) + 1j * rng.standard_normal(62)),
                     0.5 * (rng.standard_normal(62) + 1j * rng.standard_normal(62))])
    rows = rows.astype(np.complex64)  # clean, noisy with a phase ramp, noise alone
    got = t_sss.sss_find(rows, n_id_2, device=CPU)
    for i in range(3):
        ref = j_sss.sss_find(jnp.asarray(rows[i]), n_id_2)
        eq(got[0][i], ref[0])
        eq(got[1][i], ref[1])
        close(got[2][i], ref[2])
    eq(got[0][:2], [n_id_1] * 2)
    eq(got[1][:2], [sf5] * 2)
    # a root per row
    nid2 = torch.tensor([n_id_2, n_id_2, (n_id_2 + 1) % 3])
    eq(t_sss.sss_find(rows, nid2, device=CPU)[0][:2], [n_id_1] * 2)


def test_cfo_estimate_cp():
    jo, to = both_ofdm(6)
    sf = frame(6, 7, n_sf=1)
    x = np.stack([sf * np.exp(2j * np.pi * c * np.arange(len(sf)) / 128)
                  for c in (-0.4, 0.15, 0.0)]).astype(np.complex64)
    ref = np.asarray(j_cfo.cfo_estimate_cp(jnp.asarray(x), jo))
    got = t_cfo.cfo_estimate_cp(x, to, device=CPU)
    close(got, ref, scale=1.0)
    assert abs(float(got[0]) + 0.4) < 0.02 and abs(float(got[1]) - 0.15) < 0.02


# ------------------------------------------------------------------- sync
def check_sync(got, ref):
    for name in ("n_id_2", "n_id_1", "cell_id", "sf5", "peak_offset", "sf_start", "tdd"):
        eq(getattr(got, name), getattr(ref, name))
    close(got.cfo, ref.cfo, scale=1.0)
    close(got.pss_metric, ref.pss_metric, rtol=1e-3)
    close(got.sss_metric, ref.sss_metric)


def test_sync_find_fdd_windows_with_clamped_edges():
    """Windows whose PSS is found inside, at the very start (its SSS start
    clamps to 0) and at the very end of the window, delayed and CFO'd."""
    jo, to = both_ofdm(6)
    x = impair(frame(6, 301), 777, 0.21, 0.02, 5, 128)
    L = to.sf_len + 4 * to.symbol_sz
    pss0 = 777 + to.slot_len - to.symbol_sz  # the PSS of subframe 0; subframe 5's is half
    pss5 = pss0 + 5 * to.sf_len  # a frame later
    starts = (0, pss0, pss5 + 128 - L)  # inside, PSS at the start, PSS at the end
    wins = np.stack([x[s : s + L] for s in starts])
    ref = j_sync.sync_find(jnp.asarray(wins), jo)
    got = t_sync.sync_find(wins, to, device=CPU)
    check_sync(got, ref)
    eq(got.peak_offset, [pss0, 0, L - 128])
    eq(got.cell_id[[0, 2]], [301, 301])
    # one window without a batch axis, as UeSync.find calls it
    check_sync(t_sync.sync_find(wins[0], to, device=CPU), j_sync.sync_find(jnp.asarray(wins[0]), jo))


@pytest.mark.parametrize("frame_type", ["fdd", "tdd", "auto"])
def test_sync_find_frame_types(frame_type):
    """A TDD and an FDD signal through every frame_type hypothesis."""
    jo, to = both_ofdm(6)
    rng = np.random.default_rng(6)
    tdd = frame(6, 151, "tdd")
    fdd = frame(6, 33)
    noise = 0.05 * (rng.standard_normal(tdd.shape) + 1j * rng.standard_normal(tdd.shape))
    tdd = (tdd + noise).astype(np.complex64)
    wins = np.stack([tdd[: 3 * to.sf_len], tdd[4 * to.sf_len : 7 * to.sf_len],
                     fdd[: 3 * to.sf_len]])
    ref = j_sync.sync_find(jnp.asarray(wins), jo, frame_type)
    got = t_sync.sync_find(wins, to, frame_type, device=CPU)
    check_sync(got, ref)
    if frame_type != "fdd":
        eq(got.cell_id[:2], [151, 151])


@pytest.mark.parametrize("frame_type,cell_id", [("fdd", 123), ("auto", 407)])
def test_cell_search(frame_type, cell_id):
    jo, to = both_ofdm(6)
    ft = "tdd" if frame_type == "auto" else "fdd"
    f = frame(6, cell_id, ft)
    x = impair(np.concatenate([f, f]), 2049, -0.3, 0.05, 9, 128)
    ref = j_cs.cell_search(jnp.asarray(x), jo, frame_type)
    got = t_cs.cell_search(x, to, frame_type, device=CPU)
    for name in ("cell_id", "n_id_1", "n_id_2", "peak_offset", "votes", "tdd"):
        eq(getattr(got, name), getattr(ref, name))
    close(got.cfo, ref.cfo, scale=1.0)
    close(got.metric, ref.metric, rtol=1e-3)
    assert int(got.cell_id) == cell_id and bool(got.tdd) == (ft == "tdd")


def test_cell_search_noise_alone_and_ties():
    """Noise alone: nothing found in either package (every bin 0, so the
    first minimum of the vote is bin 0 and its count 0)."""
    jo, to = both_ofdm(6)
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4 * 9600) + 1j * rng.standard_normal(4 * 9600)).astype(np.complex64)
    ref = j_cs.cell_search(jnp.asarray(x), jo)
    got = t_cs.cell_search(x, to, device=CPU)
    for name in ("cell_id", "votes", "peak_offset"):
        eq(getattr(got, name), getattr(ref, name))


# ---------------------------------------------------------- CRS finder, SFO
def test_crs_signature_and_refsignal_sync():
    jc = j_params.Cell(n_prb=15, id=123, nof_ports=1)
    tc = t_params.Cell(n_prb=15, id=123, nof_ports=1)
    sig = j_rss.crs_time_signature(jc, 0)
    close(t_rss.crs_time_signature(tc, 0), sig)
    rng = np.random.default_rng(0)
    n, cfo = 10000, 0.01
    rot = np.exp(2j * np.pi * cfo * np.arange(len(sig)) / 256)
    for off_true in (3137, n - len(sig)):  # inside, and at the very end
        x = (0.05 * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
        x[off_true : off_true + len(sig)] += (2.0 * sig * rot).astype(np.complex64)
        jo, jm, jf = j_rss.refsignal_dl_sync_find(jnp.asarray(x), jc, 0)
        to, tm, tf = t_rss.refsignal_dl_sync_find(x, tc, 0, device=CPU)
        assert to == jo == off_true
        assert abs(tm - jm) <= 1e-4 * jm and abs(tf - jf) < 1e-5
        jg = j_rss.cell_find(jnp.asarray(x), 15, [7, 123, 200], 0)
        tg = t_rss.cell_find(x, 15, [7, 123, 200], 0, device=CPU)
        assert tg[:2] == jg[:2] == (123, off_true) and abs(tg[2] - jg[2]) <= 1e-4 * jg[2]
        # wrong hypotheses only: the same verdict (below the threshold, or
        # the same id and offset) in both packages
        jw = j_rss.cell_find(jnp.asarray(x), 15, [7, 200], 0)
        tw = t_rss.cell_find(x, 15, [7, 200], 0, device=CPU)
        assert (tw is None) == (jw is None)
        assert tw is None or (tw[:2] == jw[:2] and abs(tw[2] - jw[2]) <= 1e-4 * jw[2])
    assert tw is None or off_true != 3137  # the inside case finds nothing, as in test_sync.py


def test_sfo_estimate():
    rng = np.random.default_rng(2)
    f = np.arange(20)
    o = 1000 + 0.37 * f + 0.01 * rng.standard_normal(20)
    assert t_sfo.sfo_estimate(f, o, 19200, 1920000) == j_sfo.sfo_estimate(f, o, 19200, 1920000)
    assert t_sfo.sfo_estimate([1], [5], 19200, 1920000) == 0.0
    assert t_sfo.sfo_to_ppm(37.0, 1920000) == j_sfo.sfo_to_ppm(37.0, 1920000)


# ----------------------------------------------------------------- UeSync
@pytest.mark.parametrize("cut", [0, 400])
def test_ue_sync_find_and_track(cut):
    """FIND, then three blocks of 5 subframes.  cut = 400 starts the stream
    360 samples into subframe 0 (after the 40-sample delay), so FIND finds
    the PSS of subframe 0 (subframe 5's lies beyond its window) at a
    negative stream position.  The JAX package's first block then starts
    where `lax.dynamic_slice_in_dim` puts a negative start: counted from the
    end of the stream, then clamped so that the block fits (it reads the
    stream's tail); the port places it the same way."""
    jcell = j_params.Cell(n_prb=6, id=301)
    tcell = t_params.Cell(n_prb=6, id=301)
    f = frame(6, 301)
    x = impair(np.concatenate([f, f])[cut:], 40, 0.11, 0.02, 3, 128)
    js, ts = j_ues.UeSync(jcell), t_ues.UeSync(tcell)
    jst = js.find(jnp.asarray(x))
    tst = ts.find(x, device=CPU)
    assert (tst.cell_id, tst.sf_idx, tst.stream_pos) == (jst.cell_id, jst.sf_idx, jst.stream_pos)
    assert abs(tst.cfo - jst.cfo) < 1e-5
    assert (tst.stream_pos < 0) == (cut > 0)
    xt = torch.as_tensor(x)
    for _ in range(3):
        jsf, jst = js.track_block(jnp.asarray(x), jst, 5)
        tsf, tst = ts.track_block(xt, tst, 5)
        assert (tst.sf_idx, tst.stream_pos, tst.in_sync, tst.frames) == \
            (jst.sf_idx, jst.stream_pos, jst.in_sync, jst.frames)
        assert abs(tst.cfo - jst.cfo) < 1e-5
        close(tsf, np.asarray(jsf))
