"""The channel emulator, the resamplers, the AGC and the neighbour
measurement of the port against the JAX package.

The same numpy inputs go through `srslte_tpu` and `srslte_tpu_torch` on the
CPU.  Tolerances, per case:
- `FadingChannel`: within 1e-4 of the output's RMS (both form the Jakes
  gains in float32 from the same numpy seed; the FFTs run in another order);
- `fractional_delay`, `apply_hst`, `resample_fft`, `resample_arb`,
  `interp_linear_cf`: within 1e-5 (absolute, on signals of unit scale);
- `rlf_mask`: equal, sample for sample;
- `Agc.process`: gains within 1e-4 dB, output and RSSI within rtol 1e-5;
- `IntraMeasure.measure`: rtol 1e-4;
- `awgn`: statistically, the SNR within 0.3 dB of the one asked for;
- the PDSCH over ETU fading (25 PRB): the port's CPU receiver decodes the
  JAX package's faded signal with the port's own noise; the TB must pass
  its CRC and equal the bits sent, as the reference's own tests require.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.agc as j_agc
import srslte_tpu.phy.channel as j_ch
import srslte_tpu.phy.channel.hst as j_hst
import srslte_tpu.phy.resampling as j_rs
import srslte_tpu.phy.ue.intra_measure as j_im
import srslte_tpu_torch.phy.agc as t_agc
import srslte_tpu_torch.phy.channel as t_ch
import srslte_tpu_torch.phy.channel.delay as t_delay
import srslte_tpu_torch.phy.channel.hst as t_hst
import srslte_tpu_torch.phy.resampling as t_rs
import srslte_tpu_torch.phy.ue.intra_measure as t_im

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


def cnoise(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


def t(x):
    return torch.as_tensor(np.array(x))  # a writable copy: JAX's arrays are read-only


# ------------------------------------------------------------------ fading
@pytest.mark.parametrize("profile,doppler", [("epa", 5.0), ("eva", 70.0), ("etu", 300.0),
                                             ("epa", 0.0), ("eva", 0.0), ("etu", 0.0),
                                             ("none", 0.0)])
def test_fading_channel_matches_reference(profile, doppler):
    """Three blocks and a ragged tail at 1.92 Msps, t0 != 0: the same
    channel from the same seed."""
    x = cnoise(np.random.default_rng(5), 3 * 2048 + 777)
    j = j_ch.FadingChannel(profile, doppler, 1_920_000, seed=3)
    p = t_ch.FadingChannel(profile, doppler, 1_920_000, seed=3)
    want = np.asarray(j(jnp.asarray(x), t0=0.37))
    got = p(t(x), t0=0.37)
    assert got.shape == want.shape and got.dtype == torch.complex64
    rms = np.sqrt(np.mean(np.abs(want) ** 2))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * rms)
    assert (p.halo, p.nfft) == (j.halo, int(2 ** np.ceil(np.log2(j.block + j.halo))))


@pytest.mark.parametrize("doppler", [300.0, 0.0])
def test_tap_gains_match_reference(doppler):
    """The gains at 30.72 Msps block centres 4 s into the process, where
    float32 t * w is far from exact: formed as the reference forms them."""
    ts = 4.0 + (np.arange(64) * 2048 + 1024) / 30.72e6
    j = j_ch.FadingChannel("etu", doppler, 30_720_000, seed=9)
    p = t_ch.FadingChannel("etu", doppler, 30_720_000, seed=9)
    want = np.asarray(j.tap_gains(jnp.asarray(ts)))
    got = p.tap_gains(torch.as_tensor(ts, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("profile", ["epa", "eva", "etu"])
def test_fading_power_and_rayleigh(profile):
    """The analog of tests/test_channel_io.py's statistics on the port."""
    x = torch.ones(64 * 2048, dtype=torch.complex64)
    powers, cvs = [], []
    for seed in range(4):
        y = t_ch.FadingChannel(profile, 300.0, 1_920_000, seed=seed)(x).numpy()
        powers.append(np.mean(np.abs(y) ** 2))
        env = np.abs(y.reshape(-1, 2048)).mean(axis=1)
        cvs.append(env.std() / env.mean())
    assert abs(np.mean(powers) - 1.0) < 0.4, powers
    assert np.mean(cvs) > 0.1


def test_fading_static_is_lti():
    """A static channel commutes with a shift by whole blocks (the halo is
    right at block boundaries)."""
    ch = t_ch.FadingChannel("epa", 0.0, 1_920_000, seed=2)
    x = cnoise(np.random.default_rng(3), 8192)
    y1 = ch(t(x)).numpy()
    y2 = ch(t(np.roll(x, 2048))).numpy()
    np.testing.assert_allclose(y2[4096:6144], np.roll(y1, 2048)[4096:6144], atol=1e-3)


# ------------------------------------------------------ delay, HST and RLF
@pytest.mark.parametrize("delay", [7, 3.5, -2.25])
def test_fractional_delay_matches_reference(delay):
    x = cnoise(np.random.default_rng(0), (2, 1500), 0.7)
    want = np.asarray(j_ch.fractional_delay(jnp.asarray(x), delay))
    got = t_ch.fractional_delay(t(x), delay)
    assert got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    if delay == 7:
        np.testing.assert_allclose(got.numpy(), np.roll(x, 7, axis=-1), atol=1e-4)


def test_delay_drift_matches_reference():
    from srslte_tpu.phy.channel.delay import delay_drift

    ts = np.linspace(0, 3.3, 101)
    np.testing.assert_array_equal(t_delay.delay_drift(ts, 0.7, 2.5, 1_920_000),
                                  delay_drift(ts, 0.7, 2.5, 1_920_000))


@pytest.mark.parametrize("t0", [0.0, 1.79])
def test_apply_hst_matches_reference(t0):
    """The rotation is host numpy in float64 in both packages: the complex64
    factor is the same, so the product is equal to float32 rounding."""
    x = cnoise(np.random.default_rng(1), 4000)
    kw = dict(ds=300.0, d_min=2.0, v=300.0)
    want = np.asarray(j_hst.apply_hst(jnp.asarray(x), 1_920_000, 750.0, t0=t0, **kw))
    got = t_hst.apply_hst(t(x), 1_920_000, 750.0, t0=t0, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    ts = np.array([0.0, 1.79, 1.81, 3.5])
    np.testing.assert_array_equal(t_hst.hst_doppler(ts, 750.0, **kw),
                                  j_hst.hst_doppler(ts, 750.0, **kw))


def test_hst_doppler_trajectory():
    """The analog of tests/test_channel_io.py::test_hst_doppler_trajectory."""
    f = t_hst.hst_doppler(np.array([0.0, 1.79, 1.81, 3.5]), f_d=750.0, ds=300.0, d_min=2.0,
                          v=300.0)
    assert f[0] > 700 and f[1] > 0 > f[2]
    y = t_hst.apply_hst(torch.ones(2048, dtype=torch.complex64), 1_920_000, 750.0).numpy()
    assert np.allclose(np.abs(y), 1.0, atol=1e-5) and not np.allclose(y, 1.0)


@pytest.mark.parametrize("n,srate,on,off,t0", [(10_000, 10_000, 800.0, 200.0, 0.0),
                                               (3_932_160, 30_720_000, 10.0, 2.0, 0.0),
                                               (50_000, 1_920_000, 3.0, 1.5, 0.0123)])
def test_rlf_mask_equals_reference(n, srate, on, off, t0):
    """Equal sample for sample, burst edges included (float32 time axis)."""
    want = np.asarray(j_ch.rlf_mask(n, srate, on, off, t0))
    got = t_ch.rlf_mask(n, srate, on, off, t0, device=CPU)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    assert abs(got.numpy().mean() - on / (on + off)) < 0.02


# ------------------------------------------------------------------- AWGN
def test_awgn_snr():
    """The analog of tests/test_channel_io.py::test_awgn_snr; the power is
    the mean over all of x, not per row."""
    gen = torch.Generator()
    gen.manual_seed(0)
    x = torch.ones((4, 25_000), dtype=torch.complex64)
    x[0] *= 3  # rows of unequal power share one noise level
    y = t_ch.awgn(gen, x, 10.0)
    noise = (y - x).numpy()
    p = float(np.mean(np.abs(x.numpy()) ** 2))
    snr = p / np.mean(np.abs(noise) ** 2)
    assert abs(10 * np.log10(snr) - 10.0) < 0.3
    assert abs(np.mean(np.abs(noise[0]) ** 2) / np.mean(np.abs(noise[1]) ** 2) - 1) < 0.1
    n0 = t_ch.awgn_power(gen, torch.zeros(100_000, dtype=torch.complex64), 0.25)
    assert abs(float(torch.mean(torch.abs(n0) ** 2)) - 0.25) < 0.01


# ------------------------------------------------------------- resampling
@pytest.mark.parametrize("up,down", [(4, 3), (3, 4), (12, 1), (1, 12), (2, 1)])
def test_resample_fft_matches_reference(up, down):
    x = cnoise(np.random.default_rng(up * 7 + down), (2, 960), 0.5)
    want = np.asarray(j_rs.resample_fft(jnp.asarray(x), up, down))
    got = t_rs.resample_fft(t(x), up, down)
    assert got.shape == want.shape and got.dtype == torch.complex64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


def test_resample_fft_rejects_fractional_length():
    with pytest.raises(ValueError):
        t_rs.resample_fft(torch.zeros(10, dtype=torch.complex64), 1, 3)


@pytest.mark.parametrize("ratio", [2, 3])
def test_interp_linear_matches_reference(ratio):
    x = cnoise(np.random.default_rng(ratio), (3, 50))
    want = np.asarray(j_rs.interp_linear_cf(jnp.asarray(x), ratio))
    got = t_rs.interp_linear_cf(t(x), ratio)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    y = t_rs.interp_linear_cf(torch.tensor([0, 2, 4], dtype=torch.complex64), 2)
    np.testing.assert_allclose(y.real.numpy(), [0, 1, 2, 3, 4, 4], atol=1e-6)


@pytest.mark.parametrize("rate,interp", [(0.7, False), (1.25, True), (23.04 / 30.72, True),
                                         (0.876543, True)])
def test_resample_arb_matches_reference(rate, interp):
    """Equal plans (the sequential float64 accumulator) and outputs within
    1e-5; the plan's phase rows are the reference's at rational rates."""
    from srslte_tpu.phy.resampling.resampler import _arb_plan as j_plan
    from srslte_tpu_torch.phy.resampling.resampler import _arb_plan as t_plan

    x = cnoise(np.random.default_rng(3), (2, 400))
    want = np.asarray(j_rs.resample_arb(jnp.asarray(x), rate, interpolate=interp))
    got = t_rs.resample_arb(t(x), rate, interpolate=interp)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for a, b in zip(t_plan(400, float(rate), interp), j_plan(400, float(rate), interp)):
        if a is None:
            assert b is None
        else:
            np.testing.assert_array_equal(a, b)


def test_resample_arb_tone_fidelity():
    """The analog of tests/test_channel_io.py::test_resample_arb_tone_fidelity."""
    rate, n, f = 0.876543, 4096, 0.02
    x = np.exp(2j * np.pi * f * np.arange(n)).astype(np.complex64)
    y = t_rs.resample_arb(t(x), rate, interpolate=True).numpy()
    ref = np.exp(2j * np.pi * (f / rate) * np.arange(len(y)))
    core_y, core_r = y[32:-32], ref[32:-32]
    g = np.vdot(core_r, core_y) / np.vdot(core_r, core_r)
    assert np.linalg.norm(core_y - g * core_r) / np.linalg.norm(core_y) < 0.02


# -------------------------------------------------------------------- AGC
@pytest.mark.parametrize("shape,g0", [((32 * 1024,), 0.0), ((1, 20 * 1024 + 5), 6.0)])
def test_agc_matches_reference(shape, g0):
    rng = np.random.default_rng(3)
    x = cnoise(rng, shape, 0.01)
    x[..., : 5 * 1024] *= 30  # a loud start: the clamp and the recursion both work
    yj, gj, rj = j_agc.Agc(target=0.3).process(jnp.asarray(x), 1024, g0)
    yt, gt, rt = t_agc.Agc(target=0.3).process(t(x), 1024, g0)
    assert tuple(yt.shape) == np.asarray(yj).shape and tuple(gt.shape) == np.asarray(gj).shape
    assert tuple(rt.shape) == np.asarray(rj).shape
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(yj)).max())


def test_agc_batched_rows_match_reference():
    """[B, n]: each row as the reference's AGC runs it alone (the
    reference's own scan takes one row)."""
    x = cnoise(np.random.default_rng(4), (3, 8 * 512), 0.02)
    x[1] *= 50
    yt, gt, rt = t_agc.Agc(target=0.3).process(t(x), 512)
    for b in range(3):
        yj, gj, _ = j_agc.Agc(target=0.3).process(jnp.asarray(x[b]), 512)
        np.testing.assert_allclose(gt.numpy()[b], np.asarray(gj)[0], rtol=0, atol=1e-4)
        np.testing.assert_allclose(yt.numpy()[b], np.asarray(yj), rtol=1e-5,
                                   atol=1e-5 * np.abs(np.asarray(yj)).max())


def test_agc_converges():
    """The analog of tests/test_channel_io.py::test_agc_converges."""
    x = cnoise(np.random.default_rng(3), 32 * 1024, 0.01)
    y, _, _ = t_agc.Agc(target=0.3).process(t(x), 1024)
    rms = np.sqrt(np.mean(np.abs(y.numpy()[-4096:]) ** 2))
    assert abs(rms - 0.3) / 0.3 < 0.15


# ---------------------------------------------------- neighbour measurement
def cells_signal(n_prb, sf_idx, cells, batch, noise, seed):
    """The JAX eNB's subframes of each (pci, amplitude), summed, plus noise."""
    from srslte_tpu.phy.common.params import Cell
    from srslte_tpu.phy.enb.enb_dl import EnbDl

    x = 0
    for pci, gain in cells:
        enb = EnbDl(Cell(n_prb=n_prb, id=pci, nof_ports=1))
        x = x + gain * np.asarray(enb.gen_signal(enb.put_base(enb.empty_grids(), sf_idx)))[0]
    return np.stack([x + cnoise(np.random.default_rng(seed + b), x.shape, noise)
                     for b in range(batch)]).astype(np.complex64)


@pytest.mark.parametrize("n_prb,batch", [(6, 1), (15, 3)])
def test_intra_measure_matches_reference(n_prb, batch):
    pcis = (42, 111, 300)
    x = cells_signal(n_prb, 2, ((42, 1.0), (111, 0.3)), batch, 0.02, 1)
    x = x[0] if batch == 1 else x
    want = j_im.IntraMeasure(n_prb, pcis).measure(jnp.asarray(x), 2)
    got = t_im.IntraMeasure(n_prb, pcis).measure(t(x), 2, device=CPU)
    for k in ("rsrp", "rsrq", "rssi"):
        assert tuple(got[k].shape) == np.asarray(want[k]).shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-4)


def test_intra_measure_ranks_cells():
    """The analog of tests/test_measure_radio.py::test_intra_measure_ranks_cells."""
    x = cells_signal(6, 2, ((42, 1.0), (111, 0.3)), 1, 0.02, 1)[0]
    out = t_im.IntraMeasure(6, (42, 111, 300)).measure(t(x), 2, device=CPU)
    rsrp, rsrq = out["rsrp"].numpy(), out["rsrq"].numpy()
    assert rsrp[0] > 5 * rsrp[1] > 5 * rsrp[2]
    assert rsrq[0] > rsrq[1]


# ----------------------------------------------------- PDSCH over fading
@pytest.mark.parametrize("mcs,chest,snr_db", [(6, "average", 20.0), (10, "wiener", 22.0)])
def test_pdsch_over_etu_fading(mcs, chest, snr_db):
    """The analogs of tests/test_channel_io.py::test_pdsch_over_etu_fading
    (QPSK, "average") and tests/test_chest_mimo.py::
    test_pdsch_over_etu_with_wiener_chest (16QAM): the JAX eNB and channel
    make the faded subframe, the port adds its own noise and decodes it on
    the CPU; the port's channel gives the same faded signal."""
    from srslte_tpu.phy.common.params import Cell as JCell
    from srslte_tpu.phy.enb.enb_dl import EnbDl
    from srslte_tpu.phy.phch.pdsch import Pdsch as JPdsch
    from srslte_tpu.phy.phch.ra import DlGrant as JGrant
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.phy.phch.pdsch import Pdsch
    from srslte_tpu_torch.phy.phch.ra import DlGrant
    from srslte_tpu_torch.phy.ue.ue_dl import UeDl

    jcell = JCell(n_prb=25, id=9)
    jp = JPdsch(jcell, JGrant.full(25, mcs), sf_idx=4, rnti=0x10)
    bits = np.random.default_rng(11).integers(0, 2, (jp.cfg.tbs,)).astype(np.uint8)
    enb = EnbDl(jcell)
    g = enb.put_pdsch(enb.put_base(enb.empty_grids(), 4), jp, jnp.asarray(bits))
    s = enb.gen_signal(g)[..., 0, :]
    faded = np.asarray(j_ch.FadingChannel("etu", 5.0, jcell.ofdm.srate, seed=4)(s))
    ours = t_ch.FadingChannel("etu", 5.0, jcell.ofdm.srate, seed=4)(t(np.asarray(s)))
    np.testing.assert_allclose(ours.numpy(), faded, rtol=0,
                               atol=1e-4 * np.sqrt(np.mean(np.abs(faded) ** 2)))

    cell = Cell(n_prb=25, id=9)
    pdsch = Pdsch(cell, DlGrant.full(25, mcs), sf_idx=4, rnti=0x10)
    gen = torch.Generator()
    gen.manual_seed(7)
    noisy = t_ch.awgn(gen, t(faded), snr_db)
    out, ok, _ = UeDl(cell, chest_algorithm=chest).decode_pdsch(noisy, pdsch, device=CPU)
    assert bool(ok)
    np.testing.assert_array_equal(out.numpy(), bits)
