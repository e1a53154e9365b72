"""PUCCH (every format, both cyclic prefixes, shortened subframes), SRS, CQI
and the PUCCH procedures: the port against the JAX package, on the CPU.

The analogs of tests/test_pucch.py and tests/test_pucch_proc.py.  Each
PUCCH case is encoded by both packages (grids within 1e-5), sent through
the JAX package's UeUl (SC-FDMA) and a flat channel with AWGN made with
numpy, and decoded by both packages' EnbUl.decode_pucch from the same
samples: the decoded bits are equal and equal to what was sent, the metrics
within 1e-4 (float32 FFTs and sums taken in another order).  The host code
(CQI packing, format selection, resources, channel selection, TDD bundling)
is a copy, held equal over every input the reference tests use and more.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.enb.enb_ul as j_enb
import srslte_tpu.phy.phch.cqi as j_cqi
import srslte_tpu.phy.phch.pucch as j_pucch
import srslte_tpu.phy.phch.pucch_proc as j_proc
import srslte_tpu.phy.phch.srs as j_srs
import srslte_tpu.phy.ue.ue_ul as j_ue
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.enb.enb_ul as t_enb
import srslte_tpu_torch.phy.phch.cqi as t_cqi
import srslte_tpu_torch.phy.phch.pucch as t_pucch
import srslte_tpu_torch.phy.phch.pucch_proc as t_proc
import srslte_tpu_torch.phy.phch.srs as t_srs
import srslte_tpu_torch.phy.ue.ue_ul as t_ue

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


def cells(n_prb, cell_id, cp="norm", **kw):
    return (j_params.Cell(n_prb=n_prb, id=cell_id, cp=j_params.CP(cp), **kw),
            t_params.Cell(n_prb=n_prb, id=cell_id, cp=t_params.CP(cp), **kw))


def pucchs(jc, tc, fmt, n_pucch, sf_idx, rnti=0, shortened=False, **cfg):
    return (j_pucch.Pucch(jc, j_pucch.PucchConfig(fmt, n_pucch, **cfg), sf_idx, rnti, shortened),
            t_pucch.Pucch(tc, t_pucch.PucchConfig(fmt, n_pucch, **cfg), sf_idx, rnti, shortened))


def close(got, ref, rtol=1e-4, atol_rel=1e-5):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * np.abs(ref).max())


def eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def channel(rng, s, snr_db, h=0.9 * np.exp(1j * 0.8)):
    """Flat channel h and AWGN at snr_db over the signal's mean power."""
    sig = np.mean(np.abs(s) ** 2) * abs(h) ** 2
    sigma = np.sqrt(sig / 10 ** (snr_db / 10) / 2)
    return (h * s + sigma * (rng.standard_normal(s.shape)
                             + 1j * rng.standard_normal(s.shape))).astype(np.complex64)


def decode_both(jc, tc, jp, tp, s, **kw):
    oj = j_enb.EnbUl(jc).decode_pucch(jnp.asarray(s), jp, **kw)
    ot = t_enb.EnbUl(tc).decode_pucch(torch.as_tensor(s), tp, device=CPU, **kw)
    assert set(ot) == set(oj)
    for k in oj:
        if k == "metric":
            close(ot[k], oj[k])
        else:
            eq(ot[k], oj[k])
    return ot


# (cell (n_prb, id, cp), format, n_pucch, sf_idx, rnti, shortened, extra
# config, ACK bits, CQI bits, SNR dB): the cases of tests/test_pucch.py, a
# positive SR (format 1), a 2a and the format 2 region offset (n_rb_2)
CASES = {
    "1_sr": ((25, 1, "norm"), "1", 10, 3, 0, False, {}, (), (), 20.0),
    "1a_ack0": ((25, 77, "norm"), "1a", 11, 3, 0, False, {}, (0,), (), 20.0),
    "1a_ack1": ((25, 77, "norm"), "1a", 11, 3, 0, False, {}, (1,), (), 20.0),
    "1b_00": ((6, 13, "norm"), "1b", 0, 8, 0, False, {}, (0, 0), (), 20.0),
    "1b_01": ((6, 13, "norm"), "1b", 0, 8, 0, False, {}, (0, 1), (), 20.0),
    "1b_10": ((6, 13, "norm"), "1b", 0, 8, 0, False, {}, (1, 0), (), 20.0),
    "1b_11": ((6, 13, "norm"), "1b", 0, 8, 0, False, {}, (1, 1), (), 20.0),
    "2_cqi4": ((25, 91, "norm"), "2", 5, 1, 0x3C, False, {}, (), (1, 0, 1, 1), 20.0),
    "2_cqi11": ((25, 91, "norm"), "2", 5, 1, 0x3C, False, {},
                (), (1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 1), 20.0),
    "2a": ((25, 3, "norm"), "2a", 14, 5, 0x46, False, {"n_rb_2": 2}, (1,), (0, 1, 1, 0, 1), 20.0),
    "2b": ((50, 17, "norm"), "2b", 20, 6, 0x99, False, {}, (1, 0), (1, 0, 1, 1), 20.0),
    "3_bits3": ((25, 31, "norm"), "3", 7, 4, 0x1234, False, {}, (1, 0, 1), (), 10.0),
    "3_bits11": ((25, 31, "norm"), "3", 7, 4, 0x1234, False, {},
                 (0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0), (), 10.0),
    "1a_ext_ack0": ((25, 77, "ext"), "1a", 11, 3, 0, False, {}, (0,), (), 20.0),
    "1a_ext_ack1": ((25, 77, "ext"), "1a", 11, 3, 0, False, {}, (1,), (), 20.0),
    "1b_ext": ((6, 13, "ext"), "1b", 3, 2, 0, False, {}, (0, 1), (), 20.0),
    "2_ext": ((25, 9, "ext"), "2", 2, 1, 0x5BB, False, {"n_rb_2": 1}, (), (1, 0, 1, 1), 20.0),
    "3_ext": ((15, 9, "ext"), "3", 3, 7, 0x5BB, False, {}, (1, 1, 0, 1), (), 10.0),
    "1a_shortened_ack1": ((25, 31, "norm"), "1a", 7, 6, 0, True, {}, (1,), (), 20.0),
    "1a_shortened_ack0": ((25, 31, "norm"), "1a", 7, 6, 0, True, {}, (0,), (), 20.0),
    "1b_ext_shortened": ((15, 4, "ext"), "1b", 16, 0, 0, True, {"n_cs_1": 6, "delta_shift": 2},
                         (1, 1), (), 20.0),
    "3_shortened": ((25, 5, "norm"), "3", 4, 3, 0x77, True, {}, (1, 0, 1, 1, 0), (), 20.0),
}


@pytest.mark.parametrize("name", list(CASES))
def test_pucch_roundtrip(name):
    """Encode in both packages, SC-FDMA + channel, decode in both from the
    same samples: grids within 1e-5, samples within 1e-4, bits equal and
    equal to what was sent, metrics within 1e-4."""
    (n_prb, cid, cp), fmt, n, sf, rnti, short, cfg, ack, cqi, snr = CASES[name]
    jc, tc = cells(n_prb, cid, cp)
    jp, tp = pucchs(jc, tc, fmt, n, sf, rnti, short, **cfg)
    gj = np.asarray(jp.encode(ack_bits=ack, cqi_bits=cqi))
    gt = tp.encode(ack_bits=ack, cqi_bits=cqi, device=CPU)
    assert gt.dtype == torch.complex64
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5)
    sj = np.asarray(j_ue.UeUl(jc).encode_pucch(jp, ack_bits=ack, cqi_bits=cqi))
    close(t_ue.UeUl(tc).encode_pucch(tp, ack_bits=ack, cqi_bits=cqi, device=CPU), sj)
    kw = ({"nof_ack3_bits": len(ack)} if fmt == "3"
          else {"nof_cqi_bits": len(cqi)} if fmt.startswith("2") else {})
    out = decode_both(jc, tc, jp, tp, channel(np.random.default_rng(len(name)), sj, snr), **kw)
    if fmt == "1":
        assert out["detected"].tolist()
    if ack:
        assert tuple(out["ack"].tolist()) == ack
    if cqi:
        assert tuple(out["cqi"].tolist()) == cqi


def test_pucch_shortened_drops_the_last_symbol():
    """SRS-colliding subframe: the last symbol of slot 1 stays empty."""
    jc, tc = cells(25, 31)
    _, tp = pucchs(jc, tc, "1a", 7, 6, shortened=True)
    g = tp.encode(ack_bits=(1,), device=CPU).numpy()
    last = t_pucch.F1_DATA_SYMS[-1] + tc.ofdm.nsymb_slot
    prb1 = t_pucch.pucch_prb(tc, tp.cfg, 2 * 6 + 1)
    assert not np.abs(g[last, prb1 * 12 : prb1 * 12 + 12]).any()
    assert np.abs(g[last - 1, prb1 * 12 : prb1 * 12 + 12]).all()


@pytest.mark.parametrize("kind", ["format1_cs", "format1b_ext_occ", "format3_occ"])
def test_pucch_users_sharing_a_prb(kind):
    """Users on one PRB pair, separated by cyclic shift, OCC or the DFT-5
    OCC of format 3, superposed: each decodes its own bits in both packages
    (the analogs of the reference's orthogonality tests)."""
    if kind == "format1_cs":
        jc, tc = cells(25, 5)
        users = [("1a", 0, (1,)), ("1a", 1, (0,))]
        sf, kw = 2, {}
    elif kind == "format1b_ext_occ":
        jc, tc = cells(6, 13, "ext")
        users = [("1b", 0, (1, 0)), ("1b", 3, (0, 1))]
        sf, kw = 2, {}
    else:
        jc, tc = cells(6, 5)
        users = [("3", 0, (1, 0, 0, 1, 1, 0)), ("3", 1, (0, 1, 1, 1, 0, 0))]
        sf, kw = 2, {"nof_ack3_bits": 6}
    ps = [pucchs(jc, tc, fmt, n, sf, 100 + n) + (bits,) for fmt, n, bits in users]
    gj = sum(np.asarray(jp.encode(ack_bits=b)) for jp, _, b in ps)
    gt = sum(tp.encode(ack_bits=b, device=CPU) for _, tp, b in ps)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-5)
    rng = np.random.default_rng(9)
    noisy = (gj + 0.01 * (rng.standard_normal(gj.shape) + 1j * rng.standard_normal(gj.shape))
             ).astype(np.complex64)
    for jp, tp, bits in ps:
        oj = jp.decode(jnp.asarray(noisy), **kw)
        ot = tp.decode(torch.as_tensor(noisy), **kw)
        eq(ot["ack"], oj["ack"])
        close(ot["metric"], oj["metric"])
        assert tuple(ot["ack"].tolist()) == bits


def test_pucch_batched_payloads():
    """One payload per subframe of a batch ([B, n] bits) encodes as each
    payload alone does in the reference (1a, 1b, 2b with CQI and ACK, 3);
    the batched decode gives each subframe's bits."""
    jc, tc = cells(15, 21)
    rng = np.random.default_rng(4)
    B = 4
    for fmt, n, na, nc, kw in (("1a", 14, 1, 0, {}), ("1b", 2, 2, 0, {}),
                               ("2b", 3, 2, 4, {"nof_cqi_bits": 4}),
                               ("3", 6, 9, 0, {"nof_ack3_bits": 9})):
        jp, tp = pucchs(jc, tc, fmt, n, 5, 0x46)
        ack = rng.integers(0, 2, (B, na)).astype(np.uint8)
        cqi = rng.integers(0, 2, (B, nc)).astype(np.uint8)
        gt = tp.encode(ack_bits=torch.as_tensor(ack), cqi_bits=cqi, device=CPU)
        assert gt.shape == (B, tc.ofdm.nsymb_sf, tc.ofdm.nof_re)
        for b in range(B):
            gj = np.asarray(jp.encode(ack_bits=tuple(ack[b].tolist()),
                                      cqi_bits=tuple(cqi[b].tolist())))
            np.testing.assert_allclose(gt[b].numpy(), gj, rtol=0, atol=1e-5)
        out = tp.decode(gt, **kw)
        eq(out["ack"], ack)
        if nc:
            eq(out["cqi"], cqi)


def test_pucch_dtx_metric():
    """A 1a resource on which nothing was sent (noise only): both packages
    give the same decision and metric.  The metric |d0| is a ratio of two
    noise estimates, so it does not fall with the noise level (ROADMAP
    queue C)."""
    jc, tc = cells(6, 1)
    jp, tp = pucchs(jc, tc, "1a", 12, 2)
    rng = np.random.default_rng(0)
    shape = (16, tc.ofdm.nsymb_sf, tc.ofdm.nof_re)
    for scale in (1.0, 1e-3):
        noise = (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                 ).astype(np.complex64)
        oj = jp.decode(jnp.asarray(noise))
        ot = tp.decode(torch.as_tensor(noise))
        eq(ot["ack"], oj["ack"])
        close(ot["metric"], oj["metric"])


def test_pucch_rejects_what_the_reference_rejects():
    for cp, fmt, short in (("ext", "2a", False), ("ext", "2b", False), ("norm", "2", True)):
        jc, tc = cells(25, 9, cp)
        for pkg, cell in ((j_pucch, jc), (t_pucch, tc)):
            with pytest.raises(ValueError):
                pkg.Pucch(cell, pkg.PucchConfig(fmt, n_pucch=2), sf_idx=1, shortened=short)


# -------------------------------------------------------------------- SRS
@pytest.mark.parametrize("cfg", [dict(m_srs=8, k0_prb=2, comb=1, n_srs_cs=3),
                                 dict(bw=(50, 1, 1, 3, 2))])
def test_srs_roundtrip(cfg):
    """Srs.encode and Srs.estimate (channel at the comb, neighbour-difference
    noise, power) against the reference, through SC-FDMA and a flat channel
    (the analogs of test_srs_roundtrip and test_srs_config_from_bw_roundtrip)."""
    if "bw" in cfg:
        n_prb, bw_cfg, b_srs, n_rrc, cs = cfg["bw"]
        jcfg = j_srs.srs_config_from_bw(n_prb, bw_cfg=bw_cfg, b_srs=b_srs, n_rrc=n_rrc,
                                        n_srs_cs=cs)
        tcfg = t_srs.srs_config_from_bw(n_prb, bw_cfg=bw_cfg, b_srs=b_srs, n_rrc=n_rrc,
                                        n_srs_cs=cs)
        jc, tc = cells(n_prb, 11)
    else:
        jcfg, tcfg = j_srs.SrsConfig(**cfg), t_srs.SrsConfig(**cfg)
        jc, tc = cells(25, 31)
    assert dataclasses_equal(jcfg, tcfg)
    js, ts = j_srs.Srs(jc, jcfg), t_srs.Srs(tc, tcfg)
    o = tc.ofdm
    gj = np.asarray(js.encode(jnp.zeros((o.nsymb_sf, o.nof_re), jnp.complex64)))
    gt = ts.encode(torch.zeros((o.nsymb_sf, o.nof_re), dtype=torch.complex64))
    np.testing.assert_allclose(gt.numpy(), gj, rtol=0, atol=1e-6)
    s = np.asarray(j_ue.UeUl(jc).ofdm.tx_sf(jnp.asarray(gj)))
    rng = np.random.default_rng(0)
    h_true = 0.7 * np.exp(1j * 1.1)
    noisy = (h_true * s + 0.01 * (rng.standard_normal((3,) + s.shape)
                                  + 1j * rng.standard_normal((3,) + s.shape))).astype(np.complex64)
    grid_j = j_enb.EnbUl(jc).ofdm.rx_sf(jnp.asarray(noisy))
    grid_t = t_enb.EnbUl(tc).ofdm.rx_sf(torch.as_tensor(noisy))
    for got, ref in zip(ts.estimate(grid_t), js.estimate(grid_j)):
        close(got, ref)
    h, noise, _ = ts.estimate(grid_t)
    assert abs(np.mean(h.numpy()) - h_true) < 0.05 and float(noise.max()) < 1e-2


def dataclasses_equal(a, b):
    import dataclasses

    return dataclasses.asdict(a) == dataclasses.asdict(b)


# -------------------------------------------------------------------- CQI
def test_cqi_reporting():
    """The host copy (SNR -> CQI, the CQI table, wideband and subband packing)
    equals the reference, and a wideband CQI rides PUCCH format 2 end to end
    in both packages."""
    for snr in np.arange(-10, 30, 0.37):
        assert t_cqi.cqi_from_snr(snr) == j_cqi.cqi_from_snr(snr)
    assert t_cqi.CQI_TABLE == j_cqi.CQI_TABLE
    for kw in (dict(cqi=9), dict(cqi=12, pmi=2, ri=1), dict(cqi=0, ri=0), dict(cqi=15, pmi=3)):
        tr, jr = t_cqi.WidebandCqi(**kw), j_cqi.WidebandCqi(**kw)
        eq(tr.pack(), jr.pack())
        assert tr.nof_bits() == jr.nof_bits() == len(tr.pack())
        back = t_cqi.WidebandCqi.unpack(tr.pack(), has_pmi=tr.pmi is not None,
                                        has_ri=tr.ri is not None)
        assert back == tr
    sb = t_cqi.SubbandCqi(wideband=11, subband_diff=(0, 2, 1, 3))
    eq(sb.pack(), j_cqi.SubbandCqi(wideband=11, subband_diff=(0, 2, 1, 3)).pack())
    assert t_cqi.SubbandCqi.unpack(sb.pack(), 4) == sb

    jc, tc = cells(25, 91)
    jp, tp = pucchs(jc, tc, "2", 5, 1, 0x3C)
    bits = tuple(t_cqi.WidebandCqi(cqi=13).pack().tolist())
    sj = np.asarray(j_ue.UeUl(jc).encode_pucch(jp, cqi_bits=bits))
    out = decode_both(jc, tc, jp, tp, channel(np.random.default_rng(5), sj, 20.0),
                      nof_cqi_bits=4)
    assert t_cqi.WidebandCqi.unpack(out["cqi"].numpy()).cqi == 13


# -------------------------------------------------------- PUCCH procedures
ACKS = (j_proc.NACK, j_proc.ACK, j_proc.DTX)


def _uci(pkg, nof_acks=0, ncce=(0,), tpc=0, m=1, **kw):
    acks = ((pkg.AckCfg(nof_acks=nof_acks, ncce=ncce, tpc_for_pucch=tpc, tdd_ack_m=m),)
            if nof_acks else ())
    return pkg.UciUsage(acks=acks, **kw)


def _both(fn, *args, **kw):
    """fn of the reference and of the port on the same inputs (each package's
    own cells and dataclasses)."""
    def build(pkg, params):
        def conv(x):
            if isinstance(x, tuple) and x and x[0] == "uci":
                return _uci(pkg, *x[1], **x[2])
            if isinstance(x, tuple) and x and x[0] == "cfg":
                return pkg.PucchProcCfg(**x[1])
            if isinstance(x, tuple) and x and x[0] == "cell":
                return params.Cell(n_prb=50, id=1, nof_ports=1, **{
                    k: params.CP(v) if k == "cp" else v for k, v in x[1].items()})
            return x
        return getattr(pkg, fn)(*map(conv, args), **kw)

    def outcome(pkg, params):
        try:
            return build(pkg, params)
        except ValueError as e:
            return ("ValueError", str(e))
    return outcome(j_proc, j_params), outcome(t_proc, t_params)


def test_pucch_proc_formats_and_resources():
    """select_format, get_resources and get_npucch over FDD, TDD and
    extended-CP cells, SR and CQI combinations, 0-4 ACK bits, the three
    feedback modes, SPS and every TPC index: equal outputs (and equal
    errors); and the reference test's spot values."""
    cell_kinds = (("cell", {}), ("cell", {"frame_type": "tdd"}),
                  ("cell", {"cp": "ext"}))
    cfgs = [("cfg", dict(n_pucch_sr=7, n_pucch_1=36, n_pucch_2=80,
                         n3_pucch_an_list=(11, 12, 13, 14))),
            ("cfg", dict(n_pucch_1=30, feedback_mode="cs",
                         n1_pucch_an_cs=((40, 41), (50, 51), (60, 61), (70, 71)))),
            ("cfg", dict(feedback_mode="pucch3", n3_pucch_an_list=(3, 4, 5, 6))),
            ("cfg", dict(sps_enabled=True, n_pucch_1_sps=(20, 21, 22, 23)))]
    n = 0
    for cell, cfg in itertools.product(cell_kinds, cfgs):
        ckw = cell[1]
        for nof_acks, cqi, sr, tpc in itertools.product(range(5), (False, True),
                                                        (None, True, False), range(4)):
            m = 2 if (ckw.get("frame_type") == "tdd" and nof_acks == 2) else 1
            ncce = (9,) * m
            uci = ("uci", (nof_acks,), dict(cqi_enabled=cqi, sr_positive=sr, tpc=tpc,
                                            ncce=ncce, m=m))
            fj, ft = _both("select_format", cell, cfg, uci)
            assert fj == ft
            if isinstance(fj, tuple):
                continue
            rj, rt = _both("get_resources", cell, cfg, uci, fj)
            assert rj == rt
            for harq in itertools.product(ACKS, repeat=nof_acks):
                gj, gt = _both("get_npucch", cell, cfg, uci, harq)
                assert gj == gt
                n += 1
    assert n > 1000
    cfg = t_proc.PucchProcCfg(n_pucch_sr=7, n_pucch_1=36)
    cell = t_params.Cell(n_prb=50, id=1, nof_ports=1)
    assert t_proc.get_npucch(cell, cfg, _uci(t_proc, 1, ncce=(9,)), (t_proc.ACK,)) == (45, (1,))


def test_pucch_proc_tables():
    """n_pucch_tdd over its brackets, channel selection both ways and the TDD
    bundling tables: equal outputs for every input."""
    for ncce, n1, m_total in itertools.product(range(0, 40, 3), (0, 10, 36), (1, 2, 3, 4)):
        for m in range(m_total):
            assert (t_proc.n_pucch_tdd(ncce, n1, 50, m_total, m)
                    == j_proc.n_pucch_tdd(ncce, n1, 50, m_total, m))
    for a in (1, 2, 3, 4):
        for acks in itertools.product(ACKS, repeat=a):
            assert t_proc._cs_tx(acks) == j_proc._cs_tx(acks)
    for a in (2, 3, 4):
        for j, b0, b1 in itertools.product(range(a), (0, 1), (0, 1)):
            assert t_proc.cs_get_ack(a, j, (b0, b1)) == j_proc.cs_get_ack(a, j, (b0, b1))
    for m in (1, 2, 3, 4):
        for harq in itertools.product(ACKS, repeat=m):
            assert t_proc.tdd_select(harq) == j_proc.tdd_select(harq)
    assert t_proc.cs_get_ack(2, 0, (0, 1)) is None
