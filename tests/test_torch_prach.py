"""PRACH preamble generation and detection: the port against the JAX
package, on the CPU (the analogs of tests/test_prach.py).

Preambles come from the port's host generator (held equal to the
reference's), with delays and noise made by numpy; both packages'
`prach_detect` run on the same windows.  Decisions, and the timing offsets
of the detected preambles, are equal exactly; metrics agree to a relative 1e-3 (float32 FFTs of another
library, and the power floor summed in another order), or to 1e-6 of the
largest metric where they are round-off (a clean window's other roots).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.phch.prach as j_prach
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.phch.prach as t_prach

torch.set_num_threads(1)  # several test workers share the machine's cores


def configs(n_prb, **kw):
    return (j_prach.PrachConfig(j_params.OfdmParams(n_prb), **kw),
            t_prach.PrachConfig(t_params.OfdmParams(n_prb), **kw))


def detect_both(jcfg, tcfg, x, timing=True):
    """Both packages' detection of windows x; returns the port's
    (detected, metric, t_offset) as numpy after holding them to the
    reference's (the timing offsets only with `timing`)."""
    x = np.asarray(x, np.complex64)
    dj, mj, tj = (np.asarray(a) for a in j_prach.prach_detect(jcfg, jnp.asarray(x)))
    dt, mt, tt = (a.numpy() for a in t_prach.prach_detect(tcfg, torch.as_tensor(x)))
    assert dt.dtype == np.bool_ and tt.dtype == np.int32 and mt.dtype == np.float32
    np.testing.assert_array_equal(dt, dj)
    np.testing.assert_allclose(mt, mj, rtol=1e-3,
                               atol=1e-6 * float(np.abs(mj).max()))
    # a timing offset means something where a preamble is detected; elsewhere
    # it is the argmax of noise, or of round-off in a clean window
    if timing:
        np.testing.assert_array_equal(tt[dj], tj[dj])
    return dt, mt, tt


def test_preamble_lengths_format0():
    jcfg, tcfg = configs(6)
    assert (tcfg.n_fft, tcfg.n_cp, tcfg.n_seq) == (1536, 198, 1536)
    for idx in (0, 21, 63):
        s = t_prach.prach_gen(tcfg, idx)
        np.testing.assert_array_equal(s, j_prach.prach_gen(jcfg, idx))
        assert len(s) == tcfg.n_total
        np.testing.assert_allclose(s[: tcfg.n_cp], s[tcfg.n_seq :], atol=1e-6)


def test_prach_detect_all_preambles_clean():
    jcfg, tcfg = configs(6, root_seq_idx=0, zero_corr_cfg=7)  # ncs=38
    xs = np.stack([t_prach.prach_gen(tcfg, i) for i in (0, 1, 21, 22, 63)])
    det, _, toff = detect_both(jcfg, tcfg, xs)
    for row, idx in enumerate((0, 1, 21, 22, 63)):
        assert det[row, idx] and det[row].sum() == 1 and toff[row, idx] == 0


def test_prach_detect_with_delay_and_noise():
    rng = np.random.default_rng(3)
    jcfg, tcfg = configs(6, zero_corr_cfg=7)
    idx, delay = 17, 30
    s = t_prach.prach_gen(tcfg, idx)
    x = np.zeros(tcfg.n_total + 256, np.complex64)
    x[delay : delay + len(s)] = s
    x += 0.1 * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    det, _, toff = detect_both(jcfg, tcfg, x)
    assert det[idx] and abs(int(toff[idx]) - delay) <= 2


def test_prach_no_false_alarm_on_noise():
    rng = np.random.default_rng(5)
    jcfg, tcfg = configs(6, zero_corr_cfg=7)
    x = rng.standard_normal((4, tcfg.n_total)) + 1j * rng.standard_normal((4, tcfg.n_total))
    det, _, _ = detect_both(jcfg, tcfg, x)
    assert not det.any()


def test_prach_batched_windows():
    jcfg, tcfg = configs(6, zero_corr_cfg=7)
    xs = np.stack([t_prach.prach_gen(tcfg, 3), t_prach.prach_gen(tcfg, 40)])
    det, _, _ = detect_both(jcfg, tcfg, xs)
    assert det[0, 3] and det[1, 40] and det.sum() == 2


def test_logical_root_table():
    """The port's copy of prach_roots.npz equals the reference's."""
    for short in (False, True):
        np.testing.assert_array_equal(t_prach.logical_roots(short), j_prach.logical_roots(short))
    tab = t_prach.logical_roots()
    assert len(tab) == 838 and sorted(tab.tolist()) == list(range(1, 839))
    assert list(tab[:4]) == [129, 710, 140, 699]
    jcfg, tcfg = configs(6, root_seq_idx=0, zero_corr_cfg=7)
    assert tcfg.roots == jcfg.roots and tcfg.roots[0] == 129
    assert tcfg.preamble_table == jcfg.preamble_table


def test_prach_restricted_shift_algebra():
    for u in (1, 129, 140, 201, 400, 710, 837):
        assert t_prach.d_u(u) == j_prach.d_u(u)
        for n_cs in t_prach.NCS_RESTRICTED:
            assert t_prach.restricted_shifts(u, n_cs) == j_prach.restricted_shifts(u, n_cs)


def test_prach_restricted_detects_all_preambles():
    jcfg, tcfg = configs(25, root_seq_idx=22, zero_corr_cfg=4, high_speed=True)
    assert tcfg.preamble_table == jcfg.preamble_table and len(tcfg.preamble_table) == 64
    ids = (0, 17, 40, 63)
    det, _, toff = detect_both(jcfg, tcfg, np.stack([t_prach.prach_gen(tcfg, i) for i in ids]))
    for row, idx in enumerate(ids):
        assert det[row, idx] and toff[row, idx] == 0


def test_prach_restricted_doppler_alias_detected():
    """A one-subcarrier Doppler shift moves the peak to a +-d_u alias
    window, which restricted detection searches.  The timing offset is read
    from the main window, which holds only side lobes here, so it is not
    compared."""
    jcfg, tcfg = configs(25, root_seq_idx=22, zero_corr_cfg=4, high_speed=True)
    s = t_prach.prach_gen(tcfg, 5)
    t = np.arange(len(s)) / tcfg.srate
    det, _, _ = detect_both(jcfg, tcfg, s * np.exp(2j * np.pi * 1250 * t), timing=False)
    assert det[5]


def test_prach_restricted_noise_no_false_alarm():
    rng = np.random.default_rng(3)
    jcfg, tcfg = configs(25, root_seq_idx=22, zero_corr_cfg=4, high_speed=True)
    x = 0.1 * (rng.standard_normal((2, tcfg.n_total)) + 1j * rng.standard_normal((2, tcfg.n_total)))
    det, _, _ = detect_both(jcfg, tcfg, x)
    assert not det.any()


def test_prach_format4_roundtrip():
    """Short UpPTS preamble (N_zc 139, 7.5 kHz): generation, detection and
    timing."""
    jcfg, tcfg = configs(25, root_seq_idx=3, zero_corr_cfg=2, fmt=4)
    assert tcfg.nzc == 139 and tcfg.n_seq == 4096 * tcfg.srate // 30_720_000
    ids = (0, 13, 63)
    xs = np.stack([t_prach.prach_gen(tcfg, i) for i in ids])
    np.testing.assert_array_equal(xs, np.stack([j_prach.prach_gen(jcfg, i) for i in ids]))
    det, _, toff = detect_both(jcfg, tcfg, xs)
    for row, idx in enumerate(ids):
        assert det[row, idx] and toff[row, idx] == 0
        assert all(tcfg.preamble_table[int(o)] == tcfg.preamble_table[idx]
                   for o in np.flatnonzero(det[row]))


@pytest.mark.parametrize("delay", [9, 40])
def test_prach_format4_delay_and_noise(delay):
    rng = np.random.default_rng(8)
    jcfg, tcfg = configs(50, root_seq_idx=70, zero_corr_cfg=4, fmt=4)
    s = t_prach.prach_gen(tcfg, 31)
    x = np.concatenate([np.zeros(delay, np.complex64), s])[: tcfg.n_total]
    x = x + 0.05 * (rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x)))
    det, _, toff = detect_both(jcfg, tcfg, x)
    assert det[31]
    # timing resolution is one correlation lag = n_fft/139 samples
    assert abs(int(toff[31]) - delay) <= tcfg.n_fft // tcfg.nzc + 1
