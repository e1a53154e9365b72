"""Sidelink parity: `srslte_tpu_torch.phy.sidelink` against the JAX package,
on the CPU.

Analogs of every test in tests/test_sidelink.py, with `Pssch.decode` on a
batch of grids.  Inputs are made with numpy from a seed and handed to both
packages: each encoder's grid is held against the JAX one within 1e-5 of its
largest magnitude (the same float32 operations; the DFT of another
library), the channel is applied once on the host to the JAX grid, and
every hard output of the two decoders (ids, MIB-SL, SCI, CRC flags, bits)
must be equal; detector metrics within 1e-4 relative.  The JAX package's
PSSCH decoder compiles once per transport-block bucket and takes seconds
per call even then, so the file runs it on one bucket (a batch of four
grids); the other buckets' grids are held against the JAX encoder's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.sidelink as j_sl
import srslte_tpu.phy.sidelink.ra_sl as j_ra
import srslte_tpu_torch.phy.sidelink as t_sl
import srslte_tpu_torch.phy.sidelink.common as t_common
import srslte_tpu_torch.phy.sidelink.ra_sl as t_ra
from srslte_tpu_torch.phy.phch.ra import riv_type2, riv_type2_decode

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


@pytest.fixture(autouse=True, scope="module")
def _drop_xla_executables():
    """Drop the JAX package's compiled executables after this file: XLA on
    the CPU keeps each one mapped into the test worker."""
    yield
    jax.clear_caches()


def close(got, want, rel=1e-5):
    """got (tensor) within rel of want's (JAX array's) largest magnitude."""
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(float(np.abs(want).max()), 1e-30))


def chan(g, rng, h0=0.9 * np.exp(0.6j), n=0.02):
    """tests/test_sidelink.py:_chan on a host grid."""
    x = np.asarray(g) * h0
    x = x + n * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
    return x.astype(np.complex64)


def noisy(x, rng, scale=0.05):
    return (np.asarray(x) * 0.9 + scale * (rng.standard_normal(62) + 1j * rng.standard_normal(62))
            ).astype(np.complex64)


def zeros(n_prb):
    return np.zeros((14, n_prb * 12), np.complex64)


# ---------------------------------------------------------------- sync
def test_psss_sequences_distinct_unit():
    s0, s1 = t_sl.psss_sequence(0), t_sl.psss_sequence(1)
    np.testing.assert_array_equal(s0, j_sl.psss_sequence(0))
    assert np.allclose(np.abs(s0), 1, atol=1e-6)
    assert abs(np.vdot(s0, s1)) / 62 < 0.25  # low cross-correlation


def test_psss_ssss_detection():
    rng = np.random.default_rng(0)
    for n_sl_id in (0, 167, 200, 335):
        id2 = n_sl_id // 168
        d = noisy(t_sl.psss_sequence(id2), rng)
        (jg, jc), (tg, tc) = j_sl.psss_detect(jnp.asarray(d)), t_sl.psss_detect(d, device=CPU)
        assert tg == jg == id2 and tc > 0.7
        assert tc == pytest.approx(jc, rel=1e-4)
        ds = noisy(t_sl.ssss_sequence(n_sl_id).astype(np.complex64), rng)
        (jg, jc), (tg, tc) = j_sl.ssss_detect(jnp.asarray(ds)), t_sl.ssss_detect(ds, device=CPU)
        assert tg == jg == n_sl_id and tc > 0.6
        assert tc == pytest.approx(jc, rel=1e-4)


def test_detection_ties_go_to_the_first_maximum():
    """All-zero input: every correlation is 0 over the 1e-12 floor, and both
    packages pick candidate 0, the first maximum; a coherent reference of
    zeros hits the other floor."""
    z = np.zeros(62, np.complex64)
    assert t_sl.psss_detect(z, device=CPU) == j_sl.psss_detect(jnp.asarray(z)) == (0, 0.0)
    assert t_sl.ssss_detect(z, device=CPU) == j_sl.ssss_detect(jnp.asarray(z))
    d = noisy(t_sl.ssss_sequence(77).astype(np.complex64), np.random.default_rng(5))
    (jg, jc), (tg, tc) = (j_sl.ssss_detect(jnp.asarray(d), jnp.asarray(z)),
                          t_sl.ssss_detect(d, z, device=CPU))
    assert tg == jg and tc == pytest.approx(jc, rel=1e-4, abs=1e-30)


# ---------------------------------------------------------------- PSBCH
def test_psbch_roundtrip():
    rng = np.random.default_rng(1)
    mib = t_sl.MibSl(bandwidth=3, direct_frame=517, direct_subframe=9, in_coverage=1)
    jmib = j_sl.MibSl(bandwidth=3, direct_frame=517, direct_subframe=9, in_coverage=1)
    np.testing.assert_array_equal(mib.pack(), jmib.pack())
    for n_sl_id in (0, 171, 335):
        jtx = j_sl.Psbch(n_sl_id, grid_prb=6).encode(jmib, jnp.asarray(zeros(6)))
        ttx = t_sl.Psbch(n_sl_id, grid_prb=6).encode(mib, zeros(6), device=CPU)
        close(ttx, jtx)
        rx = chan(jtx, rng)
        jok, jgot = j_sl.Psbch(n_sl_id).decode(jnp.asarray(rx))
        tok, tgot = t_sl.Psbch(n_sl_id).decode(rx, device=CPU)
        assert tok and jok and tgot == mib and jgot == jmib


def test_psbch_wrong_id_fails():
    tx = t_sl.Psbch(100).encode(t_sl.MibSl(bandwidth=1), zeros(6), device=CPU)
    ok, _ = t_sl.Psbch(101).decode(tx, device=CPU)
    jok, _ = j_sl.Psbch(101).decode(jnp.asarray(tx.numpy()))
    assert not ok and not jok


def test_psbch_in_a_50_prb_grid():
    """The centre 6 PRB of a 10 MHz grid (the chip phase's sync subframe)."""
    mib, jmib = t_sl.MibSl(bandwidth=4, direct_frame=3), j_sl.MibSl(bandwidth=4, direct_frame=3)
    jtx = j_sl.Psbch(168, grid_prb=50).encode(jmib, jnp.asarray(zeros(50)))
    ttx = t_sl.Psbch(168, grid_prb=50).encode(mib, zeros(50), device=CPU)
    close(ttx, jtx)
    rx = chan(jtx, np.random.default_rng(11))
    assert t_sl.Psbch(168, 50).decode(rx, device=CPU) == (True, mib)
    assert j_sl.Psbch(168, 50).decode(jnp.asarray(rx)) == (True, jmib)


def test_sync_subframe_composition():
    """PSSS/SSSS + PSBCH coexist in one sync subframe; blind receive
    recovers the id then the MIB-SL, in both packages."""
    rng = np.random.default_rng(2)
    n_sl_id = 252
    grid = t_sl.Psbch(n_sl_id).encode(t_sl.MibSl(bandwidth=2, direct_frame=88), zeros(6),
                                      device=CPU).numpy()
    mid = 36
    for l in t_common.PSSS_SYMS:
        grid[l, mid - 31 : mid + 31] = t_sl.psss_sequence(n_sl_id // 168)
    for l in t_common.SSSS_SYMS:
        grid[l, mid - 31 : mid + 31] = t_sl.ssss_sequence(n_sl_id)
    rx = chan(grid, rng)
    p = rx[t_common.PSSS_SYMS[0], mid - 31 : mid + 31]
    s = rx[t_common.SSSS_SYMS[0], mid - 31 : mid + 31]
    id2, _ = t_sl.psss_detect(p, device=CPU)
    assert id2 == j_sl.psss_detect(jnp.asarray(p))[0]
    href = p * np.conj(t_sl.psss_sequence(id2))  # coherent SSSS via the PSSS-derived channel
    got_id, cs = t_sl.ssss_detect(s, href, device=CPU)
    jid, jcs = j_sl.ssss_detect(jnp.asarray(s), jnp.asarray(href))
    assert got_id == jid == n_sl_id and cs == pytest.approx(jcs, rel=1e-4)
    ok, got = t_sl.Psbch(got_id).decode(rx, device=CPU)
    assert ok and got == t_sl.MibSl(bandwidth=2, direct_frame=88)
    assert j_sl.Psbch(got_id).decode(jnp.asarray(rx))[0]


# ---------------------------------------------------------------- SCI-0, PSCCH
def test_sci0_codec():
    for n_prb in (15, 25, 50):
        d = t_sl.Sci0(riv=37, trp_idx=99, mcs=11, timing_advance=777, group_dst_id=200)
        bits = t_sl.pack_sci0(d, n_prb)
        np.testing.assert_array_equal(bits, j_sl.pack_sci0(
            j_sl.Sci0(riv=37, trp_idx=99, mcs=11, timing_advance=777, group_dst_id=200), n_prb))
        assert len(bits) == t_sl.sci0_size(n_prb) == j_sl.sci0_size(n_prb)
        assert t_sl.unpack_sci0(bits, n_prb) == d
    # a RIV beyond the carrier's is no SCI in either package
    bad = t_sl.pack_sci0(t_sl.Sci0(riv=1000), 25)
    assert t_sl.unpack_sci0(bad, 25) is None and j_sl.unpack_sci0(bad, 25) is None


def test_pscch_roundtrip():
    rng = np.random.default_rng(3)
    args = dict(riv=41, trp_idx=5, mcs=9, group_dst_id=17)
    jtx = j_sl.Pscch(cell_n_prb=25, prb_idx=3, cyclic_shift=6).encode(
        j_sl.Sci0(**args), jnp.asarray(zeros(25)))
    ttx = t_sl.Pscch(cell_n_prb=25, prb_idx=3, cyclic_shift=6).encode(
        t_sl.Sci0(**args), zeros(25), device=CPU)
    close(ttx, jtx)
    rx = chan(jtx, rng)
    assert t_sl.Pscch(25, 3, 6).decode(rx, device=CPU) == t_sl.Sci0(**args)
    assert j_sl.Pscch(25, 3, 6).decode(jnp.asarray(rx)) == j_sl.Sci0(**args)
    # wrong cyclic shift (different UE's resource) must not decode
    rx = chan(jtx, rng)
    assert t_sl.Pscch(25, 3, cyclic_shift=0).decode(rx, device=CPU) is None
    assert j_sl.Pscch(25, 3, cyclic_shift=0).decode(jnp.asarray(rx)) is None


# ---------------------------------------------------------------- PSSCH
def pssch_pair(**kw):
    return j_sl.Pssch(**kw), t_sl.Pssch(**kw)


@pytest.mark.parametrize("mcs,n_prb,batch", [(6, 4, 4), (14, 8, None)],
                         ids=["qpsk-4prb-batch4", "16qam-8prb"])
def test_pssch_roundtrip(mcs, n_prb, batch):
    """The JAX test's two buckets, each encoded by both packages; the first
    as a batch of 4 grids [4, 14, 300] through one `Pssch.decode` in both
    packages, one of them noise alone (its CRC fails in both).  The JAX
    package decodes that bucket only (its decoder takes 6-15 s a call): the
    port's 16QAM decode is held to the bits sent."""
    rng = np.random.default_rng(mcs)
    jp, tp = pssch_pair(cell_n_prb=25, prb_start=5, n_prb=n_prb, n_x_id=171, sf_idx=3, mcs=mcs)
    assert (tp.tbs, tp.cfg.G, tp.cfg.Qm, tp.cinit) == (jp.tbs, jp.cfg.G, jp.cfg.Qm, jp.cinit)
    shape = (tp.tbs,) if batch is None else (batch, tp.tbs)
    bits = rng.integers(0, 2, shape).astype(np.float32)
    grids = np.zeros(shape[:-1] + (14, 300), np.complex64)
    jtx = np.asarray(jp.encode(jnp.asarray(bits), jnp.asarray(grids)))
    close(tp.encode(bits, grids, device=CPU), jtx)
    # an unbatched grid is broadcast to the bits' batch (the JAX encoder
    # takes a grid of the batch's shape only)
    close(tp.encode(bits, zeros(25), device=CPU), jtx)
    rx = chan(jtx, rng)
    want = np.ones(shape[:-1], bool)
    if batch is not None:
        rx[2] = chan(np.zeros_like(rx[2]), rng)  # noise alone
        want[2] = False
    tout, tok = tp.decode(rx, device=CPU)
    np.testing.assert_array_equal(tok.numpy(), want)
    np.testing.assert_array_equal(tout.numpy()[want], bits[want])
    if batch is not None:
        jout, jok = jp.decode(jnp.asarray(rx))
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
        np.testing.assert_array_equal(tout.numpy()[want], np.asarray(jout)[want])


def test_sidelink_control_data_flow():
    """SCI-0 on PSCCH signals the PSSCH allocation; receiver follows it."""
    rng = np.random.default_rng(7)
    cell_prb = 25
    alloc = (6, 8)  # start, len
    args = dict(riv=riv_type2(cell_prb, *alloc), mcs=8, group_dst_id=42)
    pscch_j, pscch_t = j_sl.Pscch(cell_prb, 0, 3), t_sl.Pscch(cell_prb, 0, 3)
    jp, tp = pssch_pair(cell_n_prb=cell_prb, prb_start=alloc[0], n_prb=alloc[1], n_x_id=42,
                        sf_idx=5, mcs=8)
    data = rng.integers(0, 2, tp.tbs).astype(np.float32)
    jgrid = jp.encode(jnp.asarray(data), pscch_j.encode(j_sl.Sci0(**args),
                                                         jnp.asarray(zeros(cell_prb))))
    tgrid = tp.encode(data, pscch_t.encode(t_sl.Sci0(**args), zeros(cell_prb), device=CPU),
                      device=CPU)
    close(tgrid, jgrid)
    rx = chan(jgrid, rng)
    got_sci = pscch_t.decode(rx, device=CPU)
    assert got_sci == t_sl.Sci0(**args) and pscch_j.decode(jnp.asarray(rx)) == j_sl.Sci0(**args)
    rb0, l_rb = riv_type2_decode(cell_prb, got_sci.riv)
    assert (rb0, l_rb) == alloc
    p_rx = t_sl.Pssch(cell_prb, rb0, l_rb, n_x_id=got_sci.group_dst_id, sf_idx=5,
                      mcs=got_sci.mcs)
    # the JAX package's PSSCH decoder is held in test_pssch_roundtrip (each
    # bucket costs it a compilation); here the port's follows the SCI
    tout, tok = p_rx.decode(rx, device=CPU)
    assert bool(tok)
    np.testing.assert_array_equal(tout.numpy(), data)


# ------------------------------------------------------------- ra_sl (36.213)
def test_ra_sl_pool_and_pscch_resources():
    for args in ((5, 0, 9), (5, 0, 8), (4, 2, 45), (10, 0, 49)):
        assert t_ra.available_pool_prb(*args) == j_ra.available_pool_prb(*args)
    assert t_ra.available_pool_prb(5, 0, 9) == 10 and t_ra.available_pool_prb(5, 0, 8) == 9
    bitmap = [0, 1, 1, 0, 1, 1, 0, 0, 1, 0]  # L = 5 pool subframes
    for n in range(45):
        assert (t_ra.pscch_resources(4, 2, 45, bitmap, n)
                == j_ra.pscch_resources(4, 2, 45, bitmap, n))
    (p1, p2), (s1, s2) = t_ra.pscch_resources(4, 2, 45, bitmap, n_pscch=7)
    assert 2 <= p1 < 2 + 4 and 45 - 8 < p2 <= 45
    assert s1 in (1, 2, 4, 5, 8) and s2 in (1, 2, 4, 5, 8) and s1 != s2
    with pytest.raises(ValueError):
        t_ra.pscch_resources(4, 2, 45, [1] + [0] * 9, 0)


def test_ra_sl_riv_roundtrip():
    for n_prb in (6, 25, 50):
        for start, l in ((0, 1), (1, n_prb // 2), (0, n_prb), (n_prb - 2, 2)):
            riv = t_ra.ra_sl_type0_to_riv(n_prb, start, l)
            assert riv == j_ra.ra_sl_type0_to_riv(n_prb, start, l)
            assert t_ra.ra_sl_type0_from_riv(riv, n_prb) == (start, l)


def test_trp_tables_generated():
    assert t_ra.trp_indices_for_k(6, 1) == (1, 2, 4, 8, 16, 32)
    assert t_ra.trp_indices_for_k(6, 2) == (3, 5, 6, 9, 10, 12, 17, 18, 20, 24, 33, 34, 36, 40,
                                             48)
    assert t_ra.trp_bitmap(5, 8) == (1, 0, 1, 0, 0, 0, 0, 0)
    for dm, cfg in (("fdd", 0), ("tdd", 0), ("tdd", 1), ("tdd", 3), ("tdd", 6)):
        assert t_ra.n_trp(dm, cfg) == j_ra.n_trp(dm, cfg)
        n = t_ra.n_trp(dm, cfg)
        for trp in (0, 3, 5, (1 << n) - 1):
            assert ([t_ra.pssch_allowed_sf(sf, trp, dm, cfg) for sf in range(16)]
                    == [j_ra.pssch_allowed_sf(sf, trp, dm, cfg) for sf in range(16)])
    assert [sf for sf in range(16) if t_ra.pssch_allowed_sf(sf, 3, "fdd")] == [0, 1, 8, 9]
    for k in (1, 2, 4, 8):
        assert t_ra.sci_trp_choices("fdd", k) == j_ra.sci_trp_choices("fdd", k)
    with pytest.raises(ValueError):
        t_ra.sci_trp_choices("fdd", 3)  # k=3 invalid for N_TRP=8
    with pytest.raises(ValueError):
        t_ra.n_trp("tdd", 7)

