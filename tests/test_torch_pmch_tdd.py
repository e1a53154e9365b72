"""PMCH (MBSFN), the TDD tables, the DwPTS PDSCH and the band tables against
the JAX package on the CPU.

The same numpy inputs (from seeds) go through both packages.  Grids,
channel estimates and noise agree to rtol 1e-4 and atol 1e-5 of the
signal's scale (float32 products and sums in another order); tables, TBS,
decoded bits and CRC flags are equal.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.common.band as j_band
import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.common.tdd as j_tdd
import srslte_tpu.phy.ofdm as j_ofdm
import srslte_tpu.phy.phch.pdsch as j_pdsch
import srslte_tpu.phy.phch.pmch as j_pmch
import srslte_tpu.phy.phch.ra as j_ra
import srslte_tpu_torch.phy.common.band as t_band
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.common.tdd as t_tdd
import srslte_tpu_torch.phy.ofdm as t_ofdm
import srslte_tpu_torch.phy.phch.pdsch as t_pdsch
import srslte_tpu_torch.phy.phch.pmch as t_pmch
import srslte_tpu_torch.phy.phch.ra as t_ra

torch.set_num_threads(1)  # several test workers share the machine's cores


def close(got, ref, scale=None):
    """rtol 1e-4, atol 1e-5 of the signal's scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def cells(n_prb, cell_id, nof_ports=1, cp="norm"):
    return (j_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, cp=j_params.CP(cp)),
            t_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, cp=t_params.CP(cp)))


# -------------------------------------------------------------------- PMCH
def test_mbsfn_rs_geometry():
    scs = t_pmch.mbsfn_rs_subcarriers(25)
    assert scs.shape == (3, 6 * 25)
    assert scs[0, 0] == 0 and scs[1, 0] == 1 and scs[2, 0] == 0
    assert (np.diff(scs, axis=1) == 2).all()
    vals = t_pmch.mbsfn_rs_values(25, area_id=1, sf_idx=3)
    assert np.allclose(np.abs(vals), 1.0, atol=1e-6)
    assert not np.allclose(vals, t_pmch.mbsfn_rs_values(25, 2, 3))
    _, tc = cells(6, 1, cp="ext")
    assert len(t_pmch.pmch_re_indices(tc, non_mbsfn_region=2)) == 10 * 72 - 3 * 36


@pytest.mark.parametrize("mcs", [4, 12, 20])
def test_pmch_roundtrip_over_ofdm(mcs):
    """Two subframes of PMCH + MBSFN RS through the extended-CP OFDM with
    noise: the grids and the MBSFN estimate of both packages, the port's
    decode, and at mcs 20 (the chip path's) the reference's decode too (one
    JAX compilation per mcs costs about 7 s)."""
    jc, tc = cells(25, 5, cp="ext")
    jp = j_pmch.Pmch(jc, area_id=1, sf_idx=3, mcs=mcs)
    tp = t_pmch.Pmch(tc, area_id=1, sf_idx=3, mcs=mcs)
    assert dataclasses.astuple(tp.cfg)[:4] == dataclasses.astuple(jp.cfg)[:4]
    rng = np.random.default_rng(mcs)
    bits = rng.integers(0, 2, (2, tp.cfg.tbs)).astype(np.uint8)
    o = tc.ofdm
    zeros = np.zeros((2, o.nsymb_sf, o.nof_re), np.complex64)
    gj = jp.encode(jnp.asarray(bits), jnp.asarray(zeros))
    gt = tp.encode(torch.as_tensor(bits), torch.as_tensor(zeros))
    close(gt, gj)
    s = t_ofdm.Ofdm(o, normalize=True).tx_sf(gt).numpy()
    s = (s + 0.01 * (rng.standard_normal(s.shape) + 1j * rng.standard_normal(s.shape)))
    grid = t_ofdm.Ofdm(o, normalize=True).rx_sf(torch.as_tensor(s.astype(np.complex64)))
    grid_j = j_ofdm.Ofdm(jc.ofdm, normalize=True).rx_sf(jnp.asarray(s.astype(np.complex64)))
    close(grid, grid_j)
    (ce_t, nv_t), (ce_j, nv_j) = tp.chest(grid), jp.chest(grid_j)
    close(ce_t, ce_j)
    np.testing.assert_allclose(float(nv_t), float(nv_j), rtol=1e-4)
    out_t, ok_t = tp.decode(grid)
    assert ok_t.all()
    np.testing.assert_array_equal(out_t.numpy(), bits)
    if mcs == 20:
        out_j, ok_j = jp.decode(grid_j)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))


def test_pmch_wrong_area_id_fails():
    _, tc = cells(6, 5, cp="ext")
    p = t_pmch.Pmch(tc, area_id=1, sf_idx=1, mcs=8)
    bits = torch.as_tensor(np.random.default_rng(1).integers(0, 2, p.cfg.tbs, dtype=np.uint8))
    o = tc.ofdm
    tx = p.encode(bits, torch.zeros((o.nsymb_sf, o.nof_re), dtype=torch.complex64))
    _, ok = t_pmch.Pmch(tc, area_id=2, sf_idx=1, mcs=8).decode(tx)
    assert not bool(ok)
    out, ok = p.decode(tx)
    assert bool(ok) and torch.equal(out, bits)


# --------------------------------------------------------------------- TDD
def test_tdd_tables():
    assert [t.value for t in t_tdd.SfType] == [t.value for t in j_tdd.SfType]
    for name in ("SPECIAL_SF_SYMBOLS", "NOF_HARQ", "K_PUSCH", "K_PHICH"):
        assert getattr(t_tdd, name) == getattr(j_tdd, name)
    assert [[t.value for t in row] for row in t_tdd.UL_DL_CONFIGS] == \
        [[t.value for t in row] for row in j_tdd.UL_DL_CONFIGS]
    for sf_cfg in range(7):
        for ss_cfg in range(10):
            jt, tt = j_tdd.TddConfig(sf_cfg, ss_cfg), t_tdd.TddConfig(sf_cfg, ss_cfg)
            for name in ("nof_dw", "nof_gp", "nof_up", "nof_harq"):
                assert getattr(tt, name) == getattr(jt, name)
            for name in ("dl_subframes", "ul_subframes", "sr_subframes"):
                assert getattr(tt, name)() == getattr(jt, name)()
            for sf in range(10):
                assert tt.sf_type(sf).value == jt.sf_type(sf).value
                assert (tt.k_pusch(sf), tt.k_phich(sf), tt.next_ul(sf)) == \
                    (jt.k_pusch(sf), jt.k_phich(sf), jt.next_ul(sf))
            for slot in (0, 1):
                for cp in ("norm", "ext"):
                    assert tt.nof_dw_slot(slot, t_params.CP(cp)) == \
                        jt.nof_dw_slot(slot, j_params.CP(cp))
    for bad in (dict(sf_config=7), dict(ss_config=10)):
        with pytest.raises(ValueError):
            t_tdd.TddConfig(**bad)


def test_k_pusch_lands_on_ul_subframes():
    """Every non-zero table-8-2 entry points at an UL subframe (the
    reference's test_e2e_tdd check, on the port's tables)."""
    for cfg in range(7):
        tdd = t_tdd.TddConfig(sf_config=cfg)
        for sf in range(10):
            k = tdd.k_pusch(sf)
            if k:
                assert tdd.sf_type(sf) is not t_tdd.SfType.UL
                assert tdd.sf_type((sf + k) % 10) is t_tdd.SfType.UL
            k = tdd.k_phich(sf)
            if k:
                assert tdd.sf_type(sf) is t_tdd.SfType.UL
                assert tdd.sf_type((sf + k) % 10) is not t_tdd.SfType.UL


def test_dwpts_tbs_scaling():
    g = dataclasses.replace(t_ra.DlGrant.full(50, mcs=10), is_dwpts=True)
    jg = dataclasses.replace(j_ra.DlGrant.full(50, mcs=10), is_dwpts=True)
    # DwPTS TBS looked up at max(1, 0.75 * 50) = 37 PRB (ra_dl.c:403)
    assert g.tbs == jg.tbs == t_ra.dl_tbs(10, 37) < t_ra.DlGrant.full(50, mcs=10).tbs


# ss_configs 0 and 5 (3-symbol DwPTS) carry no PDSCH (36.213 §7.1.7)
@pytest.mark.parametrize("ss_config", [3, 4, 8])
def test_dwpts_pdsch_roundtrip(ss_config):
    """PDSCH confined to the DwPTS symbols of a special subframe: the RE map
    and G follow them, nothing lands beyond, and both packages decode."""
    dw = t_tdd.TddConfig(sf_config=1, ss_config=ss_config).nof_dw
    assert dw == j_tdd.SPECIAL_SF_SYMBOLS[ss_config][0]
    jc, tc = cells(15, 7)
    jg = dataclasses.replace(j_ra.DlGrant.full(15, mcs=8), is_dwpts=True)
    tg = dataclasses.replace(t_ra.DlGrant.full(15, mcs=8), is_dwpts=True)
    jp = j_pdsch.Pdsch(jc, jg, sf_idx=1, cfi=2, rnti=0x99, dwpts_symbols=dw)
    tp = t_pdsch.Pdsch(tc, tg, sf_idx=1, cfi=2, rnti=0x99, dwpts_symbols=dw)
    np.testing.assert_array_equal(tp.re_idx, jp.re_idx)
    assert dataclasses.astuple(tp.cfg)[:4] == dataclasses.astuple(jp.cfg)[:4]
    o = tc.ofdm
    assert tp.re_idx.max() < dw * o.nof_re
    assert tp.cfg.G < t_pdsch.nof_re_pdsch(tc, tg, 1, 2) * 2  # truncated against the full sf
    rng = np.random.default_rng(ss_config)
    bits = rng.integers(0, 2, (2, tg.tbs)).astype(np.uint8)
    zeros = np.zeros((2, 1, o.nsymb_sf, o.nof_re), np.complex64)
    gj = jp.encode(jnp.asarray(bits), jnp.asarray(zeros))
    gt = tp.encode(torch.as_tensor(bits), torch.as_tensor(zeros))
    close(gt, gj)
    assert not gt[..., dw:, :].abs().any()  # GP and UpPTS stay empty
    y = (gt[:, 0].numpy() + 0.02 * (rng.standard_normal((2, o.nsymb_sf, o.nof_re))
                                     + 1j * rng.standard_normal((2, o.nsymb_sf, o.nof_re))))
    y = y.astype(np.complex64)
    ce = np.ones((2, 1, o.nsymb_sf, o.nof_re), np.complex64)
    out_t, ok_t = tp.decode(torch.as_tensor(y), torch.as_tensor(ce), 1e-3)
    out_j, ok_j = jp.decode(jnp.asarray(y), jnp.asarray(ce), 1e-3)
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.all()
    np.testing.assert_array_equal(out_t.numpy(), np.asarray(out_j))
    np.testing.assert_array_equal(out_t.numpy(), bits)


# -------------------------------------------------------------------- bands
def test_bands():
    """Every EARFCN helper over the whole band table, and the errors."""
    table = t_band._bands()
    np.testing.assert_array_equal(table, j_band._bands())
    for earfcn in list(range(0, int(table[-1][2]) + 1, 37)) + [int(r[2]) for r in table]:
        assert t_band.band_from_dl_earfcn(earfcn) == j_band.band_from_dl_earfcn(earfcn)
        assert t_band.dl_freq_hz(earfcn) == j_band.dl_freq_hz(earfcn)
        assert t_band.ul_earfcn_from_dl(earfcn) == j_band.ul_earfcn_from_dl(earfcn)
    for ul in range(18000, 60000, 97):
        assert t_band.ul_freq_hz(ul) == j_band.ul_freq_hz(ul)
    for band in (int(b) for b in table[:, 0]):
        assert t_band.band_is_tdd(band) == j_band.band_is_tdd(band)
    for nr in (0, 151600, 386000, 620000, 653333, 2016667, 2100000):
        assert t_band.nr_arfcn_to_freq(nr) == j_band.nr_arfcn_to_freq(nr)
        assert t_band.get_bands_nr(nr) == j_band.get_bands_nr(nr)
        f = j_band.nr_arfcn_to_freq(nr)
        assert t_band.freq_to_nr_arfcn(f) == j_band.freq_to_nr_arfcn(f)
    with pytest.raises(ValueError):
        t_band.band_from_dl_earfcn(int(table[-1][2]) + 1)
    with pytest.raises(ValueError):
        t_band.nr_arfcn_to_freq(3279166)
