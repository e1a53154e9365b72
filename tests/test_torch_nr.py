"""NR PHY parity: `srslte_tpu_torch.phy.nr` against the JAX package, on the CPU.

Analogs of tests/test_nr_{pdsch,pdcch,uci_pucch,csi,mimo2}.py and of the PHY
tests of tests/test_nr_slot_loop.py, and a whole-slice test at 24 PRB: the
DCI search, then the PDSCH decode, both packages on the same grid.  Inputs
are made with numpy from a seed and handed to both packages.  Host tables,
grids that the encoders write, hard bits, CRC flags, DCI, UCI and CSI
payloads must be equal; LLRs within 1e-4 of their largest magnitude (the
same float32 operations, some sums taken in another order), channel
measurements within the tolerance stated at their test.  The JAX halves stay small (24 PRB, or a
grant of at most 20 PRB on the 52 PRB carrier) and each compiles once.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.nr as J
import srslte_tpu.phy.nr.csi as j_csi
import srslte_tpu.phy.nr.csi_rs as j_csi_rs
import srslte_tpu.phy.nr.dlsch_nr as j_dlsch
import srslte_tpu.phy.nr.dmrs as j_dmrs
import srslte_tpu.phy.nr.pdcch_nr as j_pdcch
import srslte_tpu.phy.nr.pucch_nr as j_pucch
import srslte_tpu.phy.nr.ra_nr as j_ra
import srslte_tpu.phy.nr.uci_nr as j_uci
import srslte_tpu_torch.phy.nr as T
import srslte_tpu_torch.phy.nr.csi as t_csi
import srslte_tpu_torch.phy.nr.csi_rs as t_csi_rs
import srslte_tpu_torch.phy.nr.dlsch_nr as t_dlsch
import srslte_tpu_torch.phy.nr.dmrs as t_dmrs
import srslte_tpu_torch.phy.nr.pdcch_nr as t_pdcch
import srslte_tpu_torch.phy.nr.pucch_nr as t_pucch
import srslte_tpu_torch.phy.nr.ra_nr as t_ra
import srslte_tpu_torch.phy.nr.uci_nr as t_uci
from srslte_tpu_torch.phy.nr.params import NSYMB_SLOT

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores
eq = np.testing.assert_array_equal


def both(cls_name, *args, **kw):
    """The same frozen dataclass built in both packages (NrCarrier,
    NrGrant, Coreset, ... given as plain values)."""
    return getattr(J, cls_name)(*args, **kw), getattr(T, cls_name)(*args, **kw)


def to_j(obj):
    """The JAX package's twin of one of the port's frozen dataclasses."""
    if not dataclasses.is_dataclass(obj):
        return obj
    mods = (J, j_csi, j_csi_rs, j_pucch, j_ra)
    cls = next(getattr(m, type(obj).__name__) for m in mods if hasattr(m, type(obj).__name__))
    return cls(**{f.name: to_j(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def chan(g, rng, h0=0.9 * np.exp(0.8j), n=0.03):
    """A grid through a flat gain and AWGN of n per component (complex64)."""
    x = np.asarray(g) * h0
    return (x + n * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))).astype(
        np.complex64)


def empty(carrier):
    return np.zeros((NSYMB_SLOT, carrier.nof_re), np.complex64)


def assert_llr_close(got, ref, rel=1e-4):
    """LLRs within rel of the largest reference magnitude, and the hard
    decisions equal wherever |ref| exceeds that."""
    got, ref = np.asarray(got), np.asarray(ref)
    tol = rel * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol
    sure = np.abs(ref) > tol
    eq((got > 0)[sure], (ref > 0)[sure])


# --------------------------------------------------------------- host tables
def test_carrier_mcs_and_tbs_tables():
    for name in ("MCS_TABLE_1", "MCS_TABLE_2", "TBS_TABLE_NR"):
        assert getattr(t_ra, name) == getattr(j_ra, name)
    for table in ("qam64", "qam256"):
        for mcs in range(len(t_ra.MCS_TABLE_1 if table == "qam64" else t_ra.MCS_TABLE_2)):
            assert t_ra.nr_mcs(mcs, table) == j_ra.nr_mcs(mcs, table)
            for n_prb in (6, 24, 52):
                for layers in (1, 2):
                    jg, tg = both("NrGrant", 0, n_prb, mcs, mcs_table=table, n_layers=layers)
                    assert (tg.tbs, tg.qm, tg.rate) == (jg.tbs, jg.qm, jg.rate)
                    assert tg.modulation.name == jg.modulation.name
    for n_re in (12, 156, 1000, 8112, 15600):
        for r in (0.1, 0.25, 0.5, 0.93):
            assert t_ra.nr_tbs(n_re, r, 6, 2) == j_ra.nr_tbs(n_re, r, 6, 2)
    for n_bwp in (24, 52):
        for start in range(0, n_bwp, 5):
            for length in range(1, n_bwp - start + 1, 3):
                riv = t_ra.riv_nr(n_bwp, start, length)
                assert riv == j_ra.riv_nr(n_bwp, start, length)
                assert t_ra.riv_nr_decode(n_bwp, riv) == (start, length)
    jc, tc = both("NrCarrier")
    assert (tc.n_prb, tc.mu, tc.n_id, tc.scs_hz, tc.nof_re) == (
        jc.n_prb, jc.mu, jc.n_id, jc.scs_hz, jc.nof_re)
    with pytest.raises(ValueError):
        T.NrCarrier(n_id=1008)


def test_nr_tbs_known_points():
    assert T.nr_tbs(156, 120 / 1024, 2) in t_ra.TBS_TABLE_NR
    assert T.nr_tbs(156 * 4, 679 / 1024, 2) in t_ra.TBS_TABLE_NR
    big = T.nr_tbs(156 * 100, 948 / 1024, 6)
    assert (big + 24) % 8 == 0 and big > 3824


def test_dci_nr_roundtrip_and_alignment():
    n_bwp = 52
    d1 = T.Dci10(rb_start=4, l_rb=24, mcs=17, ndi=1, rv=2, harq_pid=9, tpc=1, pucch_ri=5,
                 harq_timing=2)
    b1 = T.pack_dci_10(d1, n_bwp)
    assert len(b1) == T.dci_10_size(n_bwp) == J.dci_10_size(n_bwp)
    eq(b1, J.pack_dci_10(to_j(d1), n_bwp))
    assert T.unpack_dci_10(b1, n_bwp) == d1
    d0 = T.Dci00(rb_start=0, l_rb=8, mcs=10, ndi=1, harq_pid=3)
    b0 = T.pack_dci_00(d0, n_bwp, n_bwp)
    eq(b0, J.pack_dci_00(to_j(d0), n_bwp, n_bwp))
    assert len(b0) == len(b1) == T.dci_00_size(n_bwp, n_bwp)
    assert T.unpack_dci_00(b0, n_bwp) == d0
    assert T.unpack_dci_10(b0, n_bwp) is None and T.unpack_dci_00(b1, n_bwp) is None
    assert d1.grant(n_bwp) == T.NrGrant(4, 24, 17, rv=2, ndi=1, harq_pid=9)


def test_cbsegm_rules():
    s = T.nr_cbsegm(200, 0.3)
    assert s.bg == 2 and s.C == 1 and s.tb_crc_len == 16 and s.cb_crc_len == 0
    assert T.nr_cbsegm(8000, 0.7).bg == 1 and T.nr_cbsegm(8000, 0.7).tb_crc_len == 24
    s = T.nr_cbsegm(20000, 0.7)
    assert s.bg == 1 and s.C >= 3 and s.cb_crc_len == 24 and s.F == s.K - s.K_prime >= 0
    assert T.nr_cbsegm(100, 0.2).bg == 2
    for tbs in (24, 200, 292, 640, 3824, 3840, 8424, 9600, 39936, 55304, 75376):
        for rate in (0.2, 0.5, 0.9):
            assert dataclasses.asdict(T.nr_cbsegm(tbs, rate)) == dataclasses.asdict(
                J.nr_cbsegm(tbs, rate))
    for kw in (dict(tbs=39936, G=44928, Qm=6, rate=0.89), dict(tbs=9600, G=19200, Qm=2,
                                                             rate=0.5, n_layers=2)):
        assert T.NrDlschConfig(**kw).e_per_cb == J.NrDlschConfig(**kw).e_per_cb


@pytest.mark.parametrize("cfg_type", [1, 2])
def test_dmrs_tables(cfg_type):
    jc, tc = both("NrCarrier", 24, 0, 17)
    for add_pos in range(4):
        assert t_dmrs.dmrs_symbols(add_pos) == j_dmrs.dmrs_symbols(add_pos)
    for slot in (0, 4, 9):
        for l in (2, 5, 11):
            assert t_dmrs.dmrs_cinit(slot, l, 17) == j_dmrs.dmrs_cinit(slot, l, 17)
            eq(t_dmrs.dmrs_values(tc, slot, l, cfg_type), j_dmrs.dmrs_values(jc, slot, l, cfg_type))
    for delta in range(2 if cfg_type == 1 else 3):
        eq(t_dmrs.dmrs_subcarriers(tc, cfg_type, delta), j_dmrs.dmrs_subcarriers(jc, cfg_type, delta))
    assert t_dmrs.dmrs_cinit(0, 2, 1) == ((1 << 17) * 3 * 3 + 2) % (1 << 31)


def test_csi_quantize_trigger_and_pack():
    """tests/test_nr_csi.py's host tests, and every output equal to the
    reference's."""
    prev = 0
    for table in t_csi.CqiTable:
        for snr in np.arange(-12.0, 40.0, 0.5):
            cqi = t_csi.snri_db_to_cqi(table, snr)
            assert cqi == j_csi.snri_db_to_cqi(j_csi.CqiTable(table.value), snr)
    for snr in range(-10, 40, 2):
        cqi = t_csi.snri_db_to_cqi(t_csi.CqiTable.TABLE_1, snr)
        assert 0 <= cqi <= 15 and cqi >= prev
        prev = cqi
    cfg = t_csi.CsiReportCfg(periodic=t_csi.CsiPeriodic(period=20, offset=3))
    assert [s for s in range(100) if t_csi.report_trigger(cfg, s)] == [3, 23, 43, 63, 83]
    assert not t_csi.report_trigger(t_csi.CsiReportCfg(), 3)
    ch = t_csi.CsiMeasurements(wideband_snr_db=20.0, wideband_rsrp_dbm=-80.0)
    interf = t_csi.CsiMeasurements(wideband_snr_db=0.0, wideband_epre_dbm=-90.0)
    jcfg = j_csi.CsiReportCfg()
    assert t_csi.quantify(t_csi.CsiReportCfg(), ch) == t_csi.CsiReport(
        **dataclasses.asdict(j_csi.quantify(jcfg, to_j(ch))))
    assert t_csi.quantify(t_csi.CsiReportCfg(), ch, interf).cqi == j_csi.quantify(
        jcfg, to_j(ch), to_j(interf)).cqi == t_csi.snri_db_to_cqi(t_csi.CqiTable.TABLE_1, 10.0)
    for k, n in ((1, 4), (2, 5), (4, 6)):
        cfg = t_csi.CsiReportCfg(K_csi_rs=k)
        assert t_csi.nof_bits(cfg) == n == j_csi.nof_bits(j_csi.CsiReportCfg(K_csi_rs=k))
        rep = t_csi.CsiReport(cqi=11, cri=k - 1)
        bits = t_csi.pack(cfg, rep)
        eq(bits, j_csi.pack(j_csi.CsiReportCfg(K_csi_rs=k), j_csi.CsiReport(cqi=11, cri=k - 1)))
        assert t_csi.unpack(cfg, bits) == rep
    assert t_csi.nof_bits(t_csi.CsiReportCfg(quantity="none", K_csi_rs=3)) == 3


@pytest.mark.parametrize("kw", [dict(), dict(duration=2), dict(interleaved=True),
                                dict(interleaved=True, reg_bundle_size=2, interleaver_size=3),
                                dict(duration=2, interleaved=True),
                                dict(interleaved=True, reg_bundle_size=2, shift_index=11,
                                     dmrs_scrambling_id=77)])
def test_pdcch_tables(kw):
    """Candidate REs, pilots and the search-space hash equal the
    reference's; with interleaving the CCEs still partition the CORESET and
    some CCE moves (tests/test_nr_pdcch.py)."""
    jc, tc = both("NrCarrier", 48, 0, 17)
    jcs, tcs = both("Coreset", tuple([True] * 8), id=1, **kw)
    ss = dict(ue_specific=True, nof_candidates=(2, 2, 2, 1, 0))
    jss, tss = both("NrSearchSpace", **ss)
    seen, moved = set(), 0
    for ncce in range(tcs.n_cce):
        for agg in (1, 2, 4):
            if ncce % agg or ncce + agg > tcs.n_cce:
                continue
            for a, b in zip(t_pdcch._candidate_res(tc, tcs, ncce, agg),
                            j_pdcch._candidate_res(jc, jcs, ncce, agg)):
                eq(a, b)
            eq(t_pdcch._dmrs_values(tc, tcs, 3, 5, ncce, agg),
               j_pdcch._dmrs_values(jc, jcs, 3, 5, ncce, agg))
        data, dmrs, _ = t_pdcch._candidate_res(tc, tcs, ncce, 1)
        res = set(data.tolist()) | set(dmrs.tolist())
        assert len(res) == 72 and not (seen & res)
        seen |= res
        d0, m0, _ = t_pdcch._candidate_res(tc, T.Coreset(tuple([True] * 8), tcs.duration, 1),
                                           ncce, 1)
        moved += res != set(d0.tolist()) | set(m0.tolist())
    assert len(seen) == tcs.bw_prb * tcs.duration * 12
    assert moved > 0 if tcs.interleaved else moved == 0
    for slot in range(5):
        for rnti in (0x4601, 0x17A5):
            for agg in range(4):
                locs = T.pdcch_nr_locations(tcs, tss, rnti, agg, slot)
                assert locs == J.pdcch_nr_locations(jcs, jss, rnti, agg, slot)
                assert all(n % (1 << agg) == 0 and n + (1 << agg) <= tcs.n_cce for n in locs)


def test_pucch_and_uci_tables():
    jc, tc = both("NrCarrier", 52, 0, 301)
    jp, tp = j_pucch.NrPucch(jc, slot=5), t_pucch.NrPucch(tc, slot=5)
    for n in range(1, 8):
        for i in range(n):
            for m in range(n):
                assert t_pucch.occ_w(i, n, m) == j_pucch.occ_w(i, n, m)
                assert abs(abs(t_pucch.occ_w(i, n, m)) - 1) < 1e-6
    for e in (24, 32, 108, 216, 500, 1100):
        eq(t_uci.ch_interleave_idx(e), j_uci.ch_interleave_idx(e))
        assert sorted(t_uci.ch_interleave_idx(e).tolist()) == list(range(e))
    for a, e in ((12, 100), (20, 300), (400, 2200), (1100, 4000)):
        assert t_uci._polar_params(a, e) == j_uci._polar_params(a, e)
    res = dict(format=1, starting_prb=51, start_symbol=4, nof_symbols=10,
               initial_cyclic_shift=5, time_domain_occ=2)
    for a, b in zip(tp._format1_tables(t_pucch.NrPucchResource(**res)),
                    jp._format1_tables(j_pucch.NrPucchResource(**res))):
        eq(a, b)
    res = dict(format=2, starting_prb=10, start_symbol=12, nof_symbols=2, nof_prb=3)
    for a, b in zip(tp._format2_geometry(t_pucch.NrPucchResource(**res)),
                    jp._format2_geometry(j_pucch.NrPucchResource(**res))):
        eq(a, b)
    for f, kw in ((3, dict(nof_prb=2, nof_symbols=10, additional_dmrs=True)),
                  (4, dict(nof_symbols=14, occ_length=4, occ_index=3))):
        r = dict(format=f, starting_prb=5, start_symbol=0, **kw)
        tr, jr = t_pucch.NrPucchResource(**r), j_pucch.NrPucchResource(**r)
        assert tp._f34_symbols(tr) == jp._f34_symbols(jr) and tp._f34_e(tr) == jp._f34_e(jr)
        for l in tp._f34_symbols(tr)[0]:
            eq(tp._f34_dmrs_seq(tr, l), jp._f34_dmrs_seq(jr, l))


# -------------------------------------------------------------- CSI-RS
def test_csi_rs_put_and_measure():
    """The resource's grid equals the reference's; EPRE and RSRP within rtol
    1e-5, N0 (their difference) within 1e-5 of EPRE, the SNR within 0.01
    dB; and the reference's measure -> quantify -> PUCCH format 2 ->
    unpack flow on the port (tests/test_nr_csi.py)."""
    rng = np.random.default_rng(0)
    jc, tc = both("NrCarrier", 52, 0, 77)
    res = t_csi_rs.NzpCsiRs(row=1, nof_rb=52)
    slot = 4
    g = t_csi_rs.csi_rs_put(res, tc, slot, empty(tc), device=CPU).numpy()
    eq(g, np.asarray(j_csi_rs.csi_rs_put(to_j(res), jc, slot, jnp.asarray(empty(tc)))))
    for row2 in (t_csi_rs.NzpCsiRs(row=2, freq_alloc=0b000100000000, l0=6, start_rb=4,
                                   nof_rb=20, scrambling_id=9, period=5, offset=1),):
        for s in (1, 2):
            eq(t_csi_rs.csi_rs_put(row2, tc, s, empty(tc), device=CPU).numpy(),
               np.asarray(j_csi_rs.csi_rs_put(to_j(row2), jc, s, jnp.asarray(empty(tc)))))
    h0, sigma = 0.9 * np.exp(0.4j), 0.05
    rx = chan(g, rng, h0, sigma)
    meas = t_csi_rs.csi_rs_measure(res, tc, slot, rx, device=CPU)
    ref = j_csi_rs.csi_rs_measure(to_j(res), jc, slot, jnp.asarray(rx))
    for k in ("epre", "rsrp"):
        np.testing.assert_allclose(float(meas[k]), float(ref[k]), rtol=1e-5)
    # N0 = EPRE - RSRP cancels most of its operands: within 1e-5 of EPRE
    np.testing.assert_allclose(float(meas["n0"]), float(ref["n0"]), rtol=0,
                               atol=1e-5 * float(ref["epre"]))
    np.testing.assert_allclose(float(meas["snr_db"]), float(ref["snr_db"]), rtol=0, atol=0.01)
    snr_db = float(meas["snr_db"])
    assert abs(snr_db - 10 * np.log10(abs(h0) ** 2 / (2 * sigma**2))) < 2.0
    cfg = t_csi.CsiReportCfg(periodic=t_csi.CsiPeriodic(period=10, offset=4))
    assert t_csi.report_trigger(cfg, slot)
    report = t_csi.quantify(cfg, t_csi.CsiMeasurements(wideband_snr_db=snr_db))
    assert report.cqi >= 8
    pu = t_pucch.NrPucch(tc, slot)
    pres = t_pucch.NrPucchResource(format=2, starting_prb=10, start_symbol=13, nof_symbols=1,
                                   nof_prb=1)
    g2 = pu.format2_encode(empty(tc), pres, t_csi.pack(cfg, report), rnti=0x4601, device=CPU)
    got, ok = pu.format2_decode(chan(g2, rng, h0, 0.02), pres, t_csi.nof_bits(cfg),
                                rnti=0x4601, device=CPU)
    assert ok and t_csi.unpack(cfg, got) == report


# ------------------------------------------------------------ DL-SCH chain
@functools.lru_cache(maxsize=None)
def j_dlsch_decode(cfg):
    """The reference's DL-SCH decode, jitted once per bucket:
    (llr, state or None) -> (bits, ok)."""
    return jax.jit(lambda llr: j_dlsch.nr_dlsch_decode_state(
        j_dlsch.nr_dlsch_combine(llr, cfg), cfg, n_iter=10))


@pytest.mark.parametrize("tbs,rate,qm,amp,noise", [(256, 0.31, 2, 6.0, 0.0),
                                                   (3000, 0.5, 4, 6.0, 0.0),
                                                   (9600, 0.5, 2, 4.0, 0.8)])
def test_nr_dlsch_roundtrip(tbs, rate, qm, amp, noise):
    """Coded bits equal the reference's (one code block; two, with their CB
    CRCs and fillers, are held in test_nr_slice_matches_reference's grid),
    the soft buffers within rtol 1e-6, and the TBs decode (the reference's
    round-trip and multi-code-block tests)."""
    g = int(tbs / rate) // qm * qm
    tcfg = T.NrDlschConfig(tbs=tbs, G=g, Qm=qm, rate=rate)
    jcfg = J.NrDlschConfig(tbs=tbs, G=g, Qm=qm, rate=rate)
    assert (tbs + tcfg.seg.tb_crc_len) % tcfg.seg.C == 0
    rng = np.random.default_rng(tbs)
    bits = rng.integers(0, 2, (2, tbs)).astype(np.uint8)
    coded = t_dlsch.nr_dlsch_encode(bits, tcfg, device=CPU).numpy()
    assert coded.shape == (2, g)
    if tbs == 256:  # two code blocks: test_nr_slice_matches_reference's grid
        eq(coded, np.asarray(j_dlsch.nr_dlsch_encode(jnp.asarray(bits), jcfg)))
    llr = ((2.0 * coded - 1.0) * amp + noise * rng.standard_normal(coded.shape)).astype(np.float32)
    w = t_dlsch.nr_dlsch_combine(llr, tcfg, device=CPU)
    np.testing.assert_allclose(w.numpy(), np.asarray(j_dlsch.nr_dlsch_combine(
        jnp.asarray(llr), jcfg)), rtol=1e-6, atol=1e-6)
    out, ok = t_dlsch.nr_dlsch_decode_state(w, tcfg, n_iter=8)
    assert ok.all()
    eq(out.numpy(), bits)


def test_nr_dlsch_decode_matches_reference():
    """Against the reference's compiled decode (one bucket, BG2): the CRC
    flags of every TB from clean to failing and the bits of every TB that
    passes; and a HARQ combine of rv 0 and rv 2 into one soft buffer (the
    filler prior -1e4 once, 0 on the combine) equal to the reference's."""
    tcfg = T.NrDlschConfig(tbs=256, G=824, Qm=2, rate=0.31)
    jcfg = J.NrDlschConfig(tbs=256, G=824, Qm=2, rate=0.31)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2, (6, 256)).astype(np.uint8)
    coded = t_dlsch.nr_dlsch_encode(bits, tcfg, device=CPU).numpy()
    sigma = np.array([0.2, 0.6, 1.0, 1.4, 2.0, 3.0], np.float32)[:, None]
    llr = ((2.0 * coded - 1.0) + sigma * rng.standard_normal(coded.shape)).astype(np.float32)
    jb, jok = j_dlsch_decode(jcfg)(jnp.asarray(llr))
    tb, tok = t_dlsch.nr_dlsch_decode(llr, tcfg, device=CPU)
    jok = np.asarray(jok)
    eq(tok.numpy(), jok)
    assert jok[0] and not jok[-1]
    eq(tb.numpy()[jok], np.asarray(jb)[jok])
    t2 = dataclasses.replace(tcfg, rv=2)
    j2 = dataclasses.replace(jcfg, rv=2)
    c2 = t_dlsch.nr_dlsch_encode(bits, t2, device=CPU).numpy()
    eq(c2, np.asarray(j_dlsch.nr_dlsch_encode(jnp.asarray(bits), j2)))
    l2 = ((2.0 * c2 - 1.0) + sigma * rng.standard_normal(c2.shape)).astype(np.float32)
    ts = t_dlsch.nr_dlsch_combine(l2, t2, t_dlsch.nr_dlsch_combine(llr, tcfg, device=CPU),
                                  device=CPU)
    js = j_dlsch.nr_dlsch_combine(jnp.asarray(l2), j2, j_dlsch.nr_dlsch_combine(
        jnp.asarray(llr), jcfg))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-5)
    _, ok2 = t_dlsch.nr_dlsch_decode_state(ts, tcfg)
    assert ok2.sum() >= tok.sum()


# --------------------------------------------------------------- PDSCH
H2 = np.array([[1.0 + 0.1j, 0.35 - 0.2j], [-0.3 + 0.25j, 0.9 - 0.15j]], np.complex64)


def mimo_chan(g, rng, sigma):
    """Port grids [..., 2tx, nsym, nre] through H2 and AWGN -> [..., 2rx, ...]."""
    y = np.einsum("rp,...psk->...rsk", H2, np.asarray(g))
    return (y + sigma * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape))
            ).astype(np.complex64)


PDSCH_PARITY = {
    "full_slot": (dict(n_prb=24, n_id=17), dict(mcs_qm=4, rate=0.4, rnti=0x4601, slot=3)),
    "two_layers": (dict(n_prb=24, n_id=42), dict(mcs_qm=4, rate=0.48, slot=4, n_layers=2)),
    "type2_add_pos2": (dict(n_prb=52, n_id=21), dict(rnti=0x4601, slot=6, dmrs_type=2,
                                                     dmrs_add_pos=2,
                                                     grant=dict(prb_start=4, n_prb=20, mcs=14))),
}


@pytest.mark.parametrize("name", sorted(PDSCH_PARITY))
def test_nr_pdsch_matches_reference(name):
    """The encoded grid equals the reference's; LLRs (chest, interpolation,
    ZF or the 2x2 MMSE, demod, descrambling) within 1e-4 of their scale and
    the noise estimate within rtol 1e-4; the port decodes every TB."""
    car_kw, kw = PDSCH_PARITY[name]
    jc, tc = both("NrCarrier", **car_kw)
    grant = kw.pop("grant", None)
    jg, tg = both("NrGrant", **grant) if grant else (None, None)
    jp, tp = J.NrPdsch(jc, grant=jg, **kw), T.NrPdsch(tc, grant=tg, **kw)
    assert tp.tbs == jp.tbs and tp.cfg == T.NrDlschConfig(**dataclasses.asdict(jp.cfg))
    rng = np.random.default_rng(len(name))
    bits = rng.integers(0, 2, (2, tp.tbs)).astype(np.uint8)
    grid = tp.encode(bits, device=CPU).numpy()
    eq(grid, np.asarray(jp.encode(jnp.asarray(bits))))
    if tp.n_layers == 2:
        rx = mimo_chan(grid, rng, 10 ** (-16 / 20) / np.sqrt(2))
    else:
        k = np.arange(tc.nof_re)
        rx = chan(grid * (1.0 + 0.35 * np.exp(-2j * np.pi * k * 2 / tc.nof_re)), rng, 0.8, 0.03)
    llr, noise = tp.demod_llr(rx, device=CPU)
    jl, jn = jp.demod_llr(jnp.asarray(rx))
    assert_llr_close(llr.numpy(), jl)
    np.testing.assert_allclose(noise.numpy(), np.asarray(jn), rtol=1e-4)
    out, ok, info = tp.decode(rx, device=CPU)
    assert ok.all() and "noise" in info
    eq(out.numpy(), bits)


def test_nr_pdsch_e2e_awgn():
    carrier = T.NrCarrier(n_prb=24, n_id=17)
    pdsch = T.NrPdsch(carrier, mcs_qm=4, rate=0.4, rnti=0x4601, slot=3)
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (2, pdsch.tbs)).astype(np.uint8)
    grid = pdsch.encode(bits, device=CPU)
    assert grid.shape == (2, 14, carrier.nof_re)
    rx = np.asarray(grid) * (0.8 * np.exp(1j * 0.9))
    rx += 0.05 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    out, ok, _ = pdsch.decode(rx.astype(np.complex64), device=CPU)
    assert ok.all()
    eq(out.numpy(), bits)


@pytest.mark.parametrize("qm,rate,snr_db", [(2, 0.30, 10.0), (4, 0.48, 16.0), (6, 0.50, 22.0)])
def test_nr_pdsch_2layer_roundtrip(qm, rate, snr_db):
    car = T.NrCarrier(n_prb=24, n_id=42)
    p = T.NrPdsch(car, mcs_qm=qm, rate=rate, slot=4, n_layers=2)
    assert p.cfg.G == 2 * len(p.re_idx) * qm
    rng = np.random.default_rng(qm)
    bits = rng.integers(0, 2, p.tbs).astype(np.uint8)
    g = p.encode(torch.as_tensor(bits, dtype=torch.float32), device=CPU)
    assert g.shape == (2, NSYMB_SLOT, car.nof_re)
    out, ok, _ = p.decode(mimo_chan(g, rng, 10 ** (-snr_db / 20) / np.sqrt(2)), device=CPU)
    assert bool(ok)
    eq(out.numpy(), bits)


def test_nr_pdsch_dmrs_port_occ_is_cdm():
    car = T.NrCarrier(n_prb=6, n_id=7)
    p = T.NrPdsch(car, n_layers=2, slot=1)
    ks, _, occ = p._dmrs(p._dmrs_syms[0])
    eq(np.unique(occ), [-1, 1])
    g = p.encode(np.zeros(p.tbs, np.float32), device=CPU).numpy()
    a = g[0, p._dmrs_syms[0], ks]
    b = g[1, p._dmrs_syms[0], ks]
    np.testing.assert_allclose(b, a * occ, rtol=1e-6)
    np.testing.assert_allclose((a + b).reshape(-1, 2)[:, 1], 0, atol=1e-6)


def test_nr_grant_2layer_tbs_scales_and_grant_mode():
    g1 = T.NrGrant(prb_start=0, n_prb=24, mcs=20)
    g2 = T.NrGrant(prb_start=0, n_prb=24, mcs=20, n_layers=2)
    assert g2.tbs > 1.8 * g1.tbs
    car = T.NrCarrier(n_prb=52, n_id=11)
    p = T.NrPdsch(car, rnti=0x17, slot=6, grant=T.NrGrant(prb_start=8, n_prb=16, mcs=16,
                                                          n_layers=2))
    rng = np.random.default_rng(6)
    bits = rng.integers(0, 2, p.tbs).astype(np.uint8)
    out, ok, _ = p.decode(mimo_chan(p.encode(bits, device=CPU), rng, 10 ** (-20 / 20)),
                          device=CPU)
    assert bool(ok) and np.array_equal(out.numpy(), bits)


@pytest.mark.parametrize("mcs,table", [(4, "qam64"), (17, "qam64"), (27, "qam256")])
def test_grant_based_pdsch_roundtrip(mcs, table):
    car = T.NrCarrier(n_prb=52, n_id=42)
    g = T.NrGrant(prb_start=8, n_prb=16, mcs=mcs, mcs_table=table)
    p = T.NrPdsch(car, rnti=0x4601, slot=5, grant=g)
    rng = np.random.default_rng(mcs)
    bits = rng.integers(0, 2, g.tbs).astype(np.float32)
    grid = p.encode(bits, device=CPU).numpy()
    k = np.arange(car.nof_re)
    rx = grid * (1.0 + 0.4 * np.exp(-2j * np.pi * k * 2 / car.nof_re))[None, :]
    rx = (rx + 0.02 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
          ).astype(np.complex64)
    out, ok, _ = p.decode(rx, device=CPU)
    assert bool(ok) and np.array_equal(out.numpy(), bits)


@pytest.mark.parametrize("dmrs_type,add_pos", [(2, 0), (1, 1), (2, 2)])
def test_dmrs_type2_and_additional_positions(dmrs_type, add_pos):
    car = T.NrCarrier(n_prb=52, n_id=21)
    g = T.NrGrant(prb_start=4, n_prb=20, mcs=14)
    p = T.NrPdsch(car, rnti=0x4601, slot=6, grant=g, dmrs_type=dmrs_type, dmrs_add_pos=add_pos)
    assert len(t_dmrs.dmrs_subcarriers(car, dmrs_type)) / car.n_prb == (
        6 if dmrs_type == 1 else 4)
    assert len(t_dmrs.dmrs_symbols(add_pos)) == add_pos + 1
    rng = np.random.default_rng(dmrs_type * 10 + add_pos)
    bits = rng.integers(0, 2, g.tbs).astype(np.float32)
    gtx = p.encode(bits, device=CPU).numpy()
    for l in t_dmrs.dmrs_symbols(add_pos):
        row = np.abs(gtx[l])
        assert row[4 * 12 : 24 * 12].sum() > 0
        assert row[: 4 * 12].sum() == 0 and row[24 * 12 :].sum() == 0
    k = np.arange(car.nof_re)
    rx = gtx * (1.0 + 0.35 * np.exp(-2j * np.pi * k * 2 / car.nof_re))[None, :]
    rx = (rx + 0.02 * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
          ).astype(np.complex64)
    out, ok, _ = p.decode(rx, device=CPU)
    assert bool(ok) and np.array_equal(out.numpy(), bits)


# ------------------------------------------------------------------ PDCCH
def pdcch_setup(duration=1, scrambling_id=None):
    car = T.NrCarrier(n_prb=52, n_id=123)
    cs = T.Coreset(tuple([True] * 8), duration=duration, id=1, dmrs_scrambling_id=scrambling_id)
    return car, cs


@pytest.mark.parametrize("duration", [1, 2])
@pytest.mark.parametrize("agg_idx", [1, 2, 3])
def test_pdcch_nr_roundtrip(duration, agg_idx):
    car, cs = pdcch_setup(duration)
    ss = T.NrSearchSpace(ue_specific=True, nof_candidates=(0, 2, 2, 1, 0))
    rnti, slot = 0x4601, 2
    pd = T.NrPdcch(car, cs, slot=slot)
    payload = np.random.default_rng(agg_idx).integers(0, 2, 39).astype(np.uint8)
    locs = T.pdcch_nr_locations(cs, ss, rnti, agg_idx, slot)
    L = 1 << agg_idx
    grid = pd.encode(empty(car), payload, rnti, locs[0], L, device=CPU)
    rx = chan(grid, np.random.default_rng(5), 0.85 * np.exp(1.1j), 0.05)
    cands = [(n, L) for n in locs] + [(n, 2) for n in T.pdcch_nr_locations(
        cs, ss, rnti, 1, slot) if agg_idx != 1]
    hit = pd.search(rx, rnti, len(payload), cands, device=CPU)
    assert hit is not None and hit[0] == (locs[0], L)
    eq(hit[1], payload)


def test_pdcch_nr_wrong_rnti_and_scrambling_id():
    car, cs = pdcch_setup()
    ss = T.NrSearchSpace(ue_specific=True, nof_candidates=(0, 0, 2, 1, 0))
    pd = T.NrPdcch(car, cs, slot=0)
    payload = np.random.default_rng(0).integers(0, 2, 30).astype(np.uint8)
    locs = T.pdcch_nr_locations(cs, ss, 0x17A5, 2, 0)
    grid = pd.encode(empty(car), payload, 0x17A5, locs[0], 4, device=CPU)
    other = T.pdcch_nr_locations(cs, ss, 0x3333, 2, 0)
    assert pd.search(grid, 0x3333, len(payload), [(n, 4) for n in other], device=CPU) is None
    car, cs = pdcch_setup(scrambling_id=77)
    ss = T.NrSearchSpace(ue_specific=True, nof_candidates=(0, 0, 2, 0, 0))
    pd = T.NrPdcch(car, cs, slot=1)
    payload = np.ones(24, np.uint8)
    locs = T.pdcch_nr_locations(cs, ss, 0x2B0, 2, 1)
    grid = pd.encode(empty(car), payload, 0x2B0, locs[0], 4, device=CPU)
    hit = pd.search(grid, 0x2B0, len(payload), [(n, 4) for n in locs], device=CPU)
    assert hit is not None and np.array_equal(hit[1], payload)


def test_pdcch_nr_interleaved_matches_reference():
    """tests/test_nr_pdcch.py's interleaved round trip through a selective
    channel: the encoded grid equals the reference's, the search finds the
    DCI sent at its location, and a wrong RNTI finds nothing (the search is
    held against the reference's in test_nr_slice_matches_reference)."""
    jc, tc = both("NrCarrier", 48, 0, 17)
    kw = dict(duration=1, id=1, interleaved=True, reg_bundle_size=2, interleaver_size=2,
              shift_index=11)
    jcs, tcs = both("Coreset", tuple([True] * 8), **kw)
    ss = T.NrSearchSpace(ue_specific=True, nof_candidates=(0, 2, 2, 1, 0))
    rnti, slot = 0x4601, 3
    jp, tp = J.NrPdcch(jc, jcs, slot=slot), T.NrPdcch(tc, tcs, slot=slot)
    rng = np.random.default_rng(23)
    payload = rng.integers(0, 2, 39).astype(np.uint8)
    locs = T.pdcch_nr_locations(tcs, ss, rnti, 2, slot)
    grid = tp.encode(empty(tc), payload, rnti, locs[0], 4, device=CPU).numpy()
    eq(grid, np.asarray(jp.encode(jnp.asarray(empty(tc)), payload, rnti, locs[0], 4)))
    k = np.arange(tc.nof_re)
    rx = chan(grid * (1.0 + 0.4 * np.exp(-2j * np.pi * k * 3 / tc.nof_re))[None, :], rng, 1.0,
              0.04)
    cands = [(n, 4) for n in locs]
    hit = tp.search(rx, rnti, len(payload), cands, device=CPU)
    assert hit is not None and hit[0] == (locs[0], 4)
    eq(hit[1], payload)
    assert tp.search(rx, 0x3333, len(payload), cands, device=CPU) is None


# ------------------------------------------------------------------- UCI
UCI_CASES = [(1, 24), (2, 24), (5, 64), (11, 96), (14, 160), (22, 300), (40, 512), (400, 2200)]


@pytest.mark.parametrize("a,e", UCI_CASES)
def test_uci_roundtrip(a, e):
    """Coded bits equal the reference's in every regime (repetition,
    simplex, block code, polar with CRC6 and PC bits, CRC11, two segments)
    and decode back (tests/test_nr_uci_pucch.py)."""
    rng = np.random.default_rng(a)
    bits = rng.integers(0, 2, a).astype(np.uint8)
    cw = t_uci.uci_encode(bits, e, device=CPU).numpy()
    eq(cw, j_uci.uci_encode(bits, e))
    y = (1 - 2 * cw.astype(np.float32)) + 0.4 * rng.standard_normal(len(cw))
    got, ok = t_uci.uci_decode((-y * 8).astype(np.float32), a, device=CPU)
    assert ok and np.array_equal(got, bits)


@pytest.mark.parametrize("a,e", [(2, 30), (5, 64), (14, 96)])
def test_uci_decode_matches_reference(a, e):
    """Decoded bits and flags equal the reference's on noisy LLRs (the
    simplex code's vote, the block code's correlation, the PC polar list
    with its CRC6 selection), some of which fail."""
    rng = np.random.default_rng(a + e)
    for sigma in (0.5, 2.5):
        bits = rng.integers(0, 2, a).astype(np.uint8)
        cw = t_uci.uci_encode(bits, e, device=CPU).numpy().astype(np.float32)
        llr = (-((1 - 2 * cw) + sigma * rng.standard_normal(e)) * 2).astype(np.float32)
        got, ok = t_uci.uci_decode(llr, a, device=CPU)
        ref, rok = j_uci.uci_decode(jnp.asarray(llr), a)
        assert ok == rok
        eq(got, ref)


def test_uci_polar_crc_rejects_noise():
    llr = np.random.default_rng(9).standard_normal(300).astype(np.float32) * 10
    got, ok = t_uci.uci_decode(llr, 22, device=CPU)
    assert not ok and not got.any()


# ------------------------------------------------------------------ PUCCH
def test_pucch_format0_detects_shift():
    jc, tc = both("NrCarrier", 52, 0, 301)
    tp, jp = t_pucch.NrPucch(tc, slot=3), j_pucch.NrPucch(jc, slot=3)
    rng = np.random.default_rng(0)
    res = t_pucch.NrPucchResource(format=0, starting_prb=0, start_symbol=12, nof_symbols=2,
                                  initial_cyclic_shift=3)
    for tx in (0, 6):
        g = tp.format0_encode(empty(tc), res, m_cs=tx, device=CPU).numpy()
        eq(g, np.asarray(jp.format0_encode(jnp.asarray(empty(tc)), to_j(res), m_cs=tx)))
        rx = chan(g, rng)
        got = tp.format0_measure(rx, res, (0, 6), device=CPU)
        assert got == jp.format0_measure(jnp.asarray(rx), to_j(res), (0, 6))
        assert got[0] == tx and got[1] > 0.7


@pytest.mark.parametrize("bits", [[0], [1], [0, 1], [1, 1]])
def test_pucch_format1_roundtrip(bits):
    jc, tc = both("NrCarrier", 52, 0, 301)
    tp, jp = t_pucch.NrPucch(tc, slot=5), j_pucch.NrPucch(jc, slot=5)
    res = t_pucch.NrPucchResource(format=1, starting_prb=51, start_symbol=4, nof_symbols=10,
                                  initial_cyclic_shift=5, time_domain_occ=2)
    g = tp.format1_encode(empty(tc), res, np.array(bits, np.uint8), device=CPU).numpy()
    eq(g, np.asarray(jp.format1_encode(jnp.asarray(empty(tc)), to_j(res),
                                       np.array(bits, np.uint8))))
    rx = chan(g, np.random.default_rng(1))
    got, metric = tp.format1_decode(rx, res, len(bits), device=CPU)
    ref, rmetric = jp.format1_decode(jnp.asarray(rx), to_j(res), len(bits))
    assert got.tolist() == ref.tolist() == bits and metric == rmetric and metric > 0.5


PUCCH_234 = {
    "f2_4bits": (2, dict(starting_prb=10, start_symbol=13, nof_symbols=1, nof_prb=1), 4, 77),
    "f2_11bits": (2, dict(starting_prb=10, start_symbol=13, nof_symbols=1, nof_prb=2), 11, 77),
    "f2_22bits": (2, dict(starting_prb=10, start_symbol=13, nof_symbols=1, nof_prb=4), 22, 77),
    "f2_16bits_2sym": (2, dict(starting_prb=10, start_symbol=12, nof_symbols=2, nof_prb=2), 16,
                       77),
    "f3_16bits": (3, dict(starting_prb=20, start_symbol=10, nof_symbols=4, nof_prb=1), 16, 123),
    "f3_40bits": (3, dict(starting_prb=20, start_symbol=4, nof_symbols=10, nof_prb=2), 40, 123),
    "f3_60bits_add": (3, dict(starting_prb=20, start_symbol=0, nof_symbols=14, nof_prb=3,
                              additional_dmrs=True), 60, 123),
    "f4_occ2_0": (4, dict(starting_prb=5, start_symbol=0, nof_symbols=14, occ_length=2,
                          occ_index=0), 10, 55),
    "f4_occ2_1": (4, dict(starting_prb=5, start_symbol=0, nof_symbols=14, occ_length=2,
                          occ_index=1), 14, 55),
    "f4_occ4_2": (4, dict(starting_prb=5, start_symbol=0, nof_symbols=14, occ_length=4,
                          occ_index=2), 8, 55),
}


@pytest.mark.parametrize("name", sorted(PUCCH_234))
def test_pucch_formats_2_3_4_roundtrip(name):
    """Formats 2-4 (tests/test_nr_uci_pucch.py): the grid equals the
    reference's, the UCI decodes, and (format 2 with 4 bits, the block
    code, and format 3 with 16, the PC polar code) the reference decodes the
    same."""
    fmt, kw, a, n_id = PUCCH_234[name]
    jc, tc = both("NrCarrier", 52, 0, n_id)
    tp, jp = t_pucch.NrPucch(tc, slot=2), j_pucch.NrPucch(jc, slot=2)
    res = t_pucch.NrPucchResource(format=fmt, **kw)
    rng = np.random.default_rng(a)
    uci = rng.integers(0, 2, a).astype(np.uint8)
    tenc, tdec = ((tp.format2_encode, tp.format2_decode) if fmt == 2 else
                  (tp.format34_encode, tp.format34_decode))
    jenc, jdec = ((jp.format2_encode, jp.format2_decode) if fmt == 2 else
                  (jp.format34_encode, jp.format34_decode))
    g = tenc(empty(tc), res, uci, rnti=0x4601, device=CPU).numpy()
    ref = np.asarray(jenc(jnp.asarray(empty(tc)), to_j(res), uci, rnti=0x4601))
    np.testing.assert_allclose(g, ref, rtol=0, atol=1e-6)
    if fmt == 3:  # the DFT-precoded payload stays unit-average-power per used RE
        assert abs(np.mean(np.abs(g[res.start_symbol:, 240 : 240 + 12 * res.nof_prb]) ** 2)
                   - 1.0) < 0.15
    rx = chan(g, rng)
    got, ok = tdec(rx, res, a, rnti=0x4601, device=CPU)
    assert ok and np.array_equal(got, uci)
    if name in ("f2_4bits", "f3_16bits"):
        rgot, rok = jdec(jnp.asarray(rx), to_j(res), a, rnti=0x4601)
        assert rok and np.array_equal(rgot, got)


def test_pucch_multiuser():
    """Two UEs on disjoint PRBs (format 2) and on one PRB with two OCC
    indices (format 4) decode independently."""
    car = T.NrCarrier(n_prb=52, n_id=77)
    pu = t_pucch.NrPucch(car, slot=2)
    rng = np.random.default_rng(3)
    r1 = t_pucch.NrPucchResource(format=2, starting_prb=0, start_symbol=13, nof_symbols=1,
                                 nof_prb=2)
    r2 = t_pucch.NrPucchResource(format=2, starting_prb=2, start_symbol=13, nof_symbols=1,
                                 nof_prb=2)
    u1, u2 = rng.integers(0, 2, (2, 10)).astype(np.uint8)
    g = pu.format2_encode(empty(car), r1, u1, rnti=0x100, device=CPU)
    g = pu.format2_encode(g, r2, u2, rnti=0x200)
    rx = chan(g, rng)
    assert np.array_equal(pu.format2_decode(rx, r1, 10, rnti=0x100, device=CPU)[0], u1)
    assert np.array_equal(pu.format2_decode(rx, r2, 10, rnti=0x200, device=CPU)[0], u2)
    car = T.NrCarrier(n_prb=52, n_id=55)
    pu = t_pucch.NrPucch(car, slot=7)

    def mk(i):
        return t_pucch.NrPucchResource(format=4, starting_prb=5, start_symbol=0,
                                       nof_symbols=14, occ_length=2, occ_index=i)
    rng = np.random.default_rng(11)
    u1, u2 = rng.integers(0, 2, (2, 8)).astype(np.uint8)
    g = (pu.format34_encode(empty(car), mk(0), u1, rnti=0x100, device=CPU)
         + pu.format34_encode(empty(car), mk(1), u2, rnti=0x200, device=CPU))
    rx = chan(g, rng)
    for res, u, rnti in ((mk(0), u1, 0x100), (mk(1), u2, 0x200)):
        got, ok = pu.format34_decode(rx, res, 8, rnti=rnti, device=CPU)
        assert ok and np.array_equal(got, u)


# ------------------------------------------------------------- slot loop
def test_nr_slot_loop_dl_and_ul():
    """tests/test_nr_slot_loop.py's slot on the port: PDCCH (1_0) + PDSCH
    blind-decoded by the UE at 52 PRB, then the 0_0 grant's PUSCH."""
    car = T.NrCarrier(n_prb=52, n_id=77)
    cs = T.Coreset.full(48, duration=1, id=0)
    ss = T.NrSearchSpace(ue_specific=True, nof_candidates=(0, 0, 2, 1, 0))
    rnti, slot = 0x4601, 4
    rng = np.random.default_rng(0)
    dl = T.Dci10(rb_start=0, l_rb=24, mcs=15, harq_pid=1)
    pd = T.NrPdcch(car, cs, slot=slot)
    locs = T.pdcch_nr_locations(cs, ss, rnti, 2, slot)
    grid = pd.encode(empty(car), T.pack_dci_10(dl, car.n_prb), rnti, locs[0], 4, device=CPU)
    g_dl = dl.grant(car.n_prb)
    payload = rng.integers(0, 2, g_dl.tbs).astype(np.float32)
    grid = grid + T.NrPdsch(car, rnti=rnti, slot=slot, grant=g_dl).encode(payload, device=CPU)
    rx = chan(grid, rng, 0.9 * np.exp(0.5j), 0.02)
    hit = pd.search(rx, rnti, T.dci_10_size(car.n_prb), [(n, 4) for n in locs], device=CPU)
    assert hit is not None
    dci = T.unpack_dci_10(hit[1], car.n_prb)
    assert dci == dl
    bits, ok, _ = T.NrPdsch(car, rnti=rnti, slot=slot, grant=dci.grant(car.n_prb)).decode(
        rx, device=CPU)
    assert bool(ok) and np.array_equal(bits.numpy(), payload)
    ul = T.Dci00(rb_start=4, l_rb=12, mcs=9, harq_pid=2)
    pusch = T.NrPusch(car, rnti=rnti, slot=slot + 4, grant=ul.grant(car.n_prb))
    ul_payload = rng.integers(0, 2, pusch.tbs).astype(np.float32)
    ul_rx = chan(pusch.encode(ul_payload, device=CPU), rng, 0.8, 0.02)
    ul_bits, ul_ok, _ = pusch.decode(ul_rx, device=CPU)
    assert bool(ul_ok) and np.array_equal(ul_bits.numpy(), ul_payload)


def test_nr_slice_matches_reference():
    """The whole slice at 24 PRB on one grid: the gNB side of both packages
    writes the same slot (DCI 1_0 at the first L=4 location, its PDSCH), a
    selective channel and AWGN; each package's UE searches the DCI and
    decodes the PDSCH of the grant it read back.  The DCI, the LLRs (within
    1e-4 of their scale) and the decoded bits and CRC flags agree, for a
    slot that decodes and for one sent 11 dB lower that does not."""
    jc, tc = both("NrCarrier", 24, 0, 77)
    jcs, tcs = both("Coreset", (True, True, True, True), duration=1, id=0)
    ss = T.NrSearchSpace(ue_specific=True, nof_candidates=(0, 0, 2, 1, 0))
    rnti, slot = 0x4601, 4
    dci = T.Dci10(rb_start=0, l_rb=24, mcs=20)
    dci_bits = T.pack_dci_10(dci, 24)
    locs = [(n, 4) for n in T.pdcch_nr_locations(tcs, ss, rnti, 2, slot)]
    tpd, jpd = T.NrPdcch(tc, tcs, slot), J.NrPdcch(jc, jcs, slot)
    tpdsch = T.NrPdsch(tc, rnti=rnti, slot=slot, grant=dci.grant(24))
    jpdsch = J.NrPdsch(jc, rnti=rnti, slot=slot, grant=to_j(dci.grant(24)))
    rng = np.random.default_rng(24)
    bits = rng.integers(0, 2, (2, tpdsch.tbs)).astype(np.uint8)
    tx = tpd.encode(tpdsch.encode(bits, device=CPU), dci_bits, rnti, *locs[0]).numpy()
    jtx = jpd.encode(jpdsch.encode(jnp.asarray(bits)), dci_bits, rnti, *locs[0])
    eq(tx, np.asarray(jtx))
    k = np.arange(tc.nof_re)
    h = 0.9 * np.exp(0.5j) * (1.0 + 0.3 * np.exp(-2j * np.pi * k * 2 / tc.nof_re))
    y = tx * h
    n = rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape)
    rx = (y + n * np.array([0.02, 0.2])[:, None, None]).astype(np.complex64)
    ref = jpd.search(jnp.asarray(rx[0]), rnti, len(dci_bits), locs)
    assert ref[0] == locs[0]
    for s in range(2):  # the reference's search once: the same compiled shapes
        hit = tpd.search(rx[s], rnti, len(dci_bits), locs, device=CPU)
        assert hit[0] == locs[0]
        eq(hit[1], ref[1])
        assert T.unpack_dci_10(hit[1], 24) == dci
    llr, _ = tpdsch.demod_llr(rx, device=CPU)
    jllr, _ = jpdsch.demod_llr(jnp.asarray(rx))
    assert_llr_close(llr.numpy(), jllr)
    out, ok, _ = tpdsch.decode(rx, device=CPU)
    jout, jok, _ = jpdsch.decode(jnp.asarray(rx))
    eq(ok.numpy(), np.asarray(jok))
    assert ok.tolist() == [True, False]
    eq(out.numpy()[0], np.asarray(jout)[0])
    eq(out.numpy()[0], bits[0])


# ----------------------------------------------------------------- package
def test_nr_exports():
    names = {n for n in dir(J) if not n.startswith("_")
             and getattr(getattr(J, n), "__module__", "").startswith("srslte_tpu")}
    assert names and all(hasattr(T, n) for n in names)


def test_entry_points_need_a_device_or_cuda():
    """With no device named, host data goes to the CUDA device: without one
    the entry points raise (there is no silent CPU path)."""
    car = T.NrCarrier(n_prb=6)
    if torch.cuda.is_available():
        assert T.NrPdsch(car, mcs_qm=2, rate=0.3).encode(np.zeros(1, np.uint8)).is_cuda
        return
    p = T.NrPdsch(car, mcs_qm=2, rate=0.3)
    with pytest.raises(RuntimeError):
        p.encode(np.zeros(p.tbs, np.uint8))
    with pytest.raises(RuntimeError):
        T.NrPdcch(car, T.Coreset.full(6)).encode(empty(car), np.zeros(20, np.uint8), 1, 0, 1)
    with pytest.raises(RuntimeError):
        t_uci.uci_encode(np.zeros(20, np.uint8), 100)
