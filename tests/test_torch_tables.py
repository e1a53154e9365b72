"""The port's copies of the static table functions equal the JAX package's.

`srslte_tpu_torch` imports nothing of `srslte_tpu`, so it keeps its own copy of
every numpy table function it needs.  Each copy is held equal (exactly: these
are integer tables, or float tables built by the same numpy expressions) to
the reference's output here.  All on the CPU.
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest

import srslte_tpu.phy.chest.chest_dl as j_chest
import srslte_tpu.phy.common.band as j_band
import srslte_tpu.phy.chest.refsignal_dl as j_rs
import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.common.scrambling as j_scr
import srslte_tpu.phy.common.sequence as j_seq
import srslte_tpu.phy.common.tdd as j_tdd
import srslte_tpu.phy.common.zc as j_zc
import srslte_tpu.phy.fec.cbsegm as j_cbsegm
import srslte_tpu.phy.fec.convolutional as j_conv
import srslte_tpu.phy.fec.crc as j_crc
import srslte_tpu.phy.fec.turbo as j_turbo
import srslte_tpu.phy.mimo.mimo as j_mimo
import srslte_tpu.phy.modem.modem as j_modem
import srslte_tpu.phy.ofdm as j_ofdm
import srslte_tpu.phy.phch.dci as j_dci
import srslte_tpu.phy.phch.dlsch as j_dlsch
import srslte_tpu.phy.phch.pbch as j_pbch
import srslte_tpu.phy.phch.pcfich as j_pcfich
import srslte_tpu.phy.phch.pdcch as j_pdcch
import srslte_tpu.phy.phch.pdsch as j_pdsch
import srslte_tpu.phy.phch.phich as j_phich
import srslte_tpu.phy.phch.pmch as j_pmch
import srslte_tpu.phy.phch.prach as j_prach
import srslte_tpu.phy.phch.pucch as j_pucch
import srslte_tpu.phy.phch.ra as j_ra
import srslte_tpu.phy.phch.regs as j_regs
import srslte_tpu.phy.phch.srs as j_srs
import srslte_tpu.phy.sync.pss as j_pss
import srslte_tpu.phy.sync.sss as j_sss
import srslte_tpu_torch.phy.chest.chest_dl as t_chest
import srslte_tpu_torch.phy.common.band as t_band
import srslte_tpu_torch.phy.chest.refsignal_dl as t_rs
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.common.scrambling as t_scr
import srslte_tpu_torch.phy.common.sequence as t_seq
import srslte_tpu_torch.phy.common.tdd as t_tdd
import srslte_tpu_torch.phy.common.zc as t_zc
import srslte_tpu_torch.phy.fec.cbsegm as t_cbsegm
import srslte_tpu_torch.phy.fec.convolutional as t_conv
import srslte_tpu_torch.phy.fec.crc as t_crc
import srslte_tpu_torch.phy.fec.turbo as t_turbo
import srslte_tpu_torch.phy.mimo.mimo as t_mimo
import srslte_tpu_torch.phy.modem.modem as t_modem
import srslte_tpu_torch.phy.ofdm as t_ofdm
import srslte_tpu_torch.phy.phch.dci as t_dci
import srslte_tpu_torch.phy.phch.dlsch as t_dlsch
import srslte_tpu_torch.phy.phch.pbch as t_pbch
import srslte_tpu_torch.phy.phch.pcfich as t_pcfich
import srslte_tpu_torch.phy.phch.pdcch as t_pdcch
import srslte_tpu_torch.phy.phch.pdsch as t_pdsch
import srslte_tpu_torch.phy.phch.phich as t_phich
import srslte_tpu_torch.phy.phch.pmch as t_pmch
import srslte_tpu_torch.phy.phch.prach as t_prach
import srslte_tpu_torch.phy.phch.pucch as t_pucch
import srslte_tpu_torch.phy.phch.ra as t_ra
import srslte_tpu_torch.phy.phch.regs as t_regs
import srslte_tpu_torch.phy.phch.srs as t_srs
import srslte_tpu_torch.phy.sync.pss as t_pss
import srslte_tpu_torch.phy.sync.sss as t_sss

ROOT = pathlib.Path(__file__).resolve().parent.parent
PRBS = (6, 15, 25, 50, 75, 100)


def cells(n_prb, cell_id=1, **kw):
    """The same cell in both packages."""
    cp = kw.pop("cp", "norm")
    return (j_params.Cell(n_prb=n_prb, id=cell_id, cp=j_params.CP(cp), **kw),
            t_params.Cell(n_prb=n_prb, id=cell_id, cp=t_params.CP(cp), **kw))


def eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- imports
def test_port_imports_nothing_of_jax_or_the_jax_package():
    pat = re.compile(r"import jax|from jax|from srslte_tpu[ .]|import srslte_tpu( |$|\.)")
    files = sorted((ROOT / "srslte_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 30
    # the blind receiver's modules, the example pair and the rest of the DL
    # are among them
    names = {str(f.relative_to(ROOT)) for f in files}
    for mod in ("phy/io/filesource.py", "phy/sync/pss.py", "phy/sync/sync.py",
                "phy/sync/refsignal_sync.py", "phy/sync/sfo.py", "phy/ue/ue_cell_search.py",
                "phy/ue/ue_sync.py", "phy/ue/ue_mib.py", "phy/phch/pbch.py",
                "examples/pdsch_enodeb.py", "examples/pdsch_ue.py", "phy/mimo/mimo.py",
                "phy/chest/chest_dl.py", "phy/phch/phich.py", "phy/phch/pmch.py",
                "phy/phch/dci.py", "phy/phch/pdsch.py", "phy/common/tdd.py",
                "phy/common/band.py", "phy/channel/awgn.py", "phy/channel/fading.py",
                "phy/channel/delay.py", "phy/channel/hst.py", "phy/channel/rlf.py",
                "phy/channel/__init__.py", "phy/resampling/resampler.py", "phy/agc.py",
                "phy/ue/intra_measure.py", "phy/io/net.py", "runtime/native.py", "radio.py",
                "net/zmq_rf.py",
                # the S1 wire path and its tooling
                "s1ap/__init__.py", "s1ap/aper.py", "s1ap/messages.py", "net/s1_transport.py",
                "epc/gtpc.py", "enb_s1.py", "epc/wire.py", "epc/mbms_gw.py", "net/tun.py",
                "ttcn3.py", "utils/config.py", "utils/crash.py", "utils/metrics.py",
                "utils/pcap.py", "utils/sysmetrics.py", "utils/tprof.py", "utils/trace.py",
                # the NR stack and the NB-IoT downlink
                "mac/pdu_nr.py", "mac/harq_nr.py", "rlc/um_nr.py", "rlc/am_nr.py",
                "pdcp/entity_nr.py", "nr_worker.py", "nr_stack.py", "vnf.py",
                "phy/nbiot/__init__.py", "phy/nbiot/nrs.py", "phy/nbiot/sync.py",
                "phy/nbiot/npdsch.py", "phy/nbiot/npdcch.py", "phy/nbiot/npbch.py",
                "phy/nbiot/ue.py", "examples/npdsch_enodeb.py", "examples/npdsch_ue.py",
                # the sidelink, the scale-out modules and the rest of the scripts
                "phy/sidelink/__init__.py", "phy/sidelink/common.py", "phy/sidelink/sync.py",
                "phy/sidelink/ra_sl.py", "phy/sidelink/channels.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/halo.py", "parallel/pipeline.py",
                "parallel/time_shard.py", "examples/cell_search.py", "examples/zmq_remote_rx.py",
                "examples/run_epc.py", "examples/run_enb.py", "examples/run_ue.py"):
        assert f"srslte_tpu_torch/{mod}" in names, mod
    hits = [f"{f.relative_to(ROOT)}:{i + 1}: {line}"
            for f in files for i, line in enumerate(f.read_text().splitlines())
            if pat.search(line)]
    assert hits == []
    # the pattern itself must not take the port's own name for the reference's
    assert not pat.search("from srslte_tpu_torch.phy import ofdm")
    assert not pat.search("import srslte_tpu_torch.convert")
    assert pat.search("from srslte_tpu.phy import ofdm") and pat.search("import srslte_tpu")


def test_only_the_zmq_transport_imports_zmq():
    """pyzmq is optional (the card's machine has none): only
    `net/zmq_rf.py` imports it, under a guard, and `chip_smoke.py` does not
    import that module."""
    pat = re.compile(r"^\s*(import zmq|from zmq)")
    files = sorted((ROOT / "srslte_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    hits = {str(f.relative_to(ROOT)) for f in files
            if any(pat.search(line) for line in f.read_text().splitlines())}
    assert hits == {"srslte_tpu_torch/net/zmq_rf.py"}
    assert "zmq_rf" not in (ROOT / "chip_smoke.py").read_text()


# ----------------------------------------------------------------- params
@pytest.mark.parametrize("cp", ["norm", "ext"])
@pytest.mark.parametrize("n_prb", PRBS)
def test_cell_and_ofdm_params(n_prb, cp):
    jc, tc = cells(n_prb, 301, cp=cp)
    assert {f.name for f in dataclasses.fields(jc)} == {f.name for f in dataclasses.fields(tc)}
    for name in ("n_id_1", "n_id_2", "nof_re_sf"):
        assert getattr(jc, name) == getattr(tc, name)
    jo, to = jc.ofdm, tc.ofdm
    for name in ("symbol_sz", "nof_re", "nof_guards", "nsymb_slot", "nsymb_sf",
                 "slot_len", "sf_len", "srate"):
        assert getattr(jo, name) == getattr(to, name)
    assert jo.cp_lens_slot() == to.cp_lens_slot()
    assert jo.symbol_offsets_slot() == to.symbol_offsets_slot()
    assert j_params.sampling_freq_hz(n_prb) == t_params.sampling_freq_hz(n_prb)
    assert j_params.nof_prb(jo.symbol_sz) == t_params.nof_prb(to.symbol_sz)


# -------------------------------------------------------- gold / scrambling
@pytest.mark.parametrize("seed,length", [(0, 31), (1, 32), (0x46 << 14, 1000),
                                         (2**31 - 1, 82800), (123456, 7)])
def test_gold_sequences(seed, length):
    eq(j_seq.gold_sequence(seed, length), t_seq.gold_sequence(seed, length))
    eq(j_seq.gold_sequence_signed(seed, length), t_seq.gold_sequence_signed(seed, length))


def test_scrambling_seeds():
    for sf in (0, 4, 9):
        for cid in (0, 1, 503):
            assert j_scr.pdsch_cinit(0x46, 0, sf, cid) == t_scr.pdsch_cinit(0x46, 0, sf, cid)
            assert j_scr.pcfich_cinit(sf, cid) == t_scr.pcfich_cinit(sf, cid)
            assert j_scr.pdcch_cinit(sf, cid) == t_scr.pdcch_cinit(sf, cid)
            assert j_scr.pusch_cinit(0x46, sf, cid) == t_scr.pusch_cinit(0x46, sf, cid)
            assert j_scr.pbch_cinit(cid) == t_scr.pbch_cinit(cid)


# -------------------------------------------------------------------- crc
@pytest.mark.parametrize("name", ["LTE_CRC24A", "LTE_CRC24B", "LTE_CRC16", "LTE_CRC8"])
def test_crc_matrix_and_bits(name):
    assert getattr(j_crc, name) == getattr(t_crc, name)
    poly, order = getattr(t_crc, name)
    for length in (1, 28, 44, 1000):
        eq(j_crc.crc_matrix(length, poly, order), t_crc.crc_matrix(length, poly, order))
    bits = np.random.default_rng(0).integers(0, 2, (3, 200)).astype(np.uint8)
    eq(j_crc.crc_bits(bits, poly, order), t_crc.crc_bits(bits, poly, order))
    eq(j_crc.crc_attach(bits, poly, order), t_crc.crc_attach(bits, poly, order))


# ----------------------------------------------------------------- cbsegm
def test_cb_sizes():
    assert j_cbsegm.cb_sizes() == t_cbsegm.cb_sizes()
    for k in (40, 512, 1024, 5824, 6144):
        assert j_cbsegm.cb_index(k) == t_cbsegm.cb_index(k)


@pytest.mark.parametrize("tbs", [16, 1000, 6120, 6121, 12960, 63776, 75376])
def test_cbsegm(tbs):
    assert dataclasses.asdict(j_cbsegm.cbsegm(tbs)) == dataclasses.asdict(t_cbsegm.cbsegm(tbs))


# ------------------------------------------------------------------ turbo
@pytest.mark.parametrize("k", [40, 512, 1024, 2112, 5824, 6144])
def test_qpp_perm(k):
    eq(j_turbo.qpp_perm(k), t_turbo.qpp_perm(k))
    eq(j_turbo.qpp_perm_inv(k), t_turbo.qpp_perm_inv(k))


def test_trellis_tables_and_encoder():
    for a, b in zip(j_turbo.trellis_tables(), t_turbo.trellis_tables()):
        eq(a, b)
    # the port keeps no generator matrix: encoding the unit vectors gives it
    eq(j_turbo._encoder_matrix(40), t_turbo.turbo_encode(np.eye(40, dtype=np.uint8), 40,
                                                          device="cpu").numpy())
    bits = np.random.default_rng(1).integers(0, 2, (2, 104)).astype(np.uint8)
    eq(j_turbo.turbo_encode_np(bits), t_turbo.turbo_encode_np(bits))


@pytest.mark.parametrize("k,e,rv,f", [(40, 132, 0, 0), (40, 300, 0, 8), (512, 700, 0, 0),
                                      (1024, 1500, 2, 0), (5824, 7524, 0, 0),
                                      (5824, 7530, 0, 0)])
def test_rate_matching_tables(k, e, rv, f):
    eq(j_turbo.rm_indices(k, e, rv, f), t_turbo.rm_indices(k, e, rv, f))
    (ji, jr), (ti, tr) = (j_turbo._rm_rx_inverse(k, e, rv, f, None),
                          t_turbo._rm_rx_inverse(k, e, rv, f, None))
    assert jr == tr
    eq(ji, ti)
    assert j_turbo.rm_k0(k, rv) == t_turbo.rm_k0(k, rv)


# ---------------------------------------------------------- convolutional
@pytest.mark.parametrize("length,e", [(44, 72), (44, 576), (27, 144), (40, 288)])
def test_conv_tables(length, e):
    eq(j_conv.rm_conv_indices(3 * length, e), t_conv.rm_conv_indices(3 * length, e))
    for a, b in zip(j_conv._rm_conv_rx_inverse(3 * length, e),
                    t_conv._rm_conv_rx_inverse(3 * length, e)):
        eq(a, b)
    eq(j_conv._encoder_matrix(length), t_conv._encoder_matrix(length))
    for a, b in zip(j_conv._branch_tables(), t_conv._branch_tables()):
        eq(a, b)


def test_kernel_trellis_tables():
    """The closed-form trellis tables of the kernels' plain versions (the
    same closed forms the CUDA sources use) against the reference's tables."""
    from srslte_tpu.phy.fec.tdec import _trellis_unrolled
    from srslte_tpu_torch.ops.tdec_cuda import _trellis_index_tables
    from srslte_tpu_torch.ops.viterbi_cuda import GENS, TB_ITER, _acs_tables

    pred, code, signs = _acs_tables()
    jpred, _, jbr = j_conv._pred_tables()  # [64, 2], [64, 2, 3] coded bits
    eq(pred, jpred.astype(np.int64))
    eq(signs[code], (2.0 * jbr - 1.0).astype(np.float32))
    assert GENS == j_conv.GENS == t_conv.GENS and TB_ITER == j_conv.TB_ITER

    pred8, gidx, n0, p0, n1, g1i = _trellis_index_tables()
    preds, succs = _trellis_unrolled()
    for sp in range(8):
        branches = {(int(pred8[sp, b]), int(gidx[sp, b])) for b in (0, 1)}
        assert branches == {(s, (u << 1) | p) for s, u, p in preds[sp]}
        (jn0, jp0), (jn1, jp1) = succs[sp]
        assert (n0[sp], p0[sp], n1[sp], g1i[sp]) == (jn0, jp0, jn1, 2 | jp1)


# ------------------------------------------------------------------ modem
@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "QAM16", "QAM64", "QAM256"])
def test_constellations(mod):
    eq(j_modem.constellation(j_modem.Modulation[mod]),
       t_modem.constellation(t_modem.Modulation[mod]))


# ------------------------------------------------------------ regs / ra
@pytest.mark.parametrize("n_prb,cell_id", [(6, 0), (6, 301), (25, 1), (25, 150), (50, 7),
                                           (100, 1), (100, 503)])
def test_reg_layout(n_prb, cell_id):
    jc, tc = cells(n_prb, cell_id)
    jl, tl = j_regs.reg_layout(jc), t_regs.reg_layout(tc)
    eq(jl.pcfich_re, tl.pcfich_re)
    eq(jl.phich_re, tl.phich_re)
    assert jl.n_cce == tl.n_cce
    for cfi in (1, 2, 3):
        eq(jl.pdcch_re[cfi], tl.pdcch_re[cfi])
        assert j_regs.nof_ctrl_symbols(jc, cfi) == t_regs.nof_ctrl_symbols(tc, cfi)


def test_tbs_table_and_grants():
    assert j_ra.TBS_TABLE == t_ra.TBS_TABLE
    assert j_ra.DL_MCS_TO_ITBS == t_ra.DL_MCS_TO_ITBS
    assert j_ra.TBS_FORMAT1C == t_ra.TBS_FORMAT1C
    for n_prb in PRBS:
        for mcs in (0, 9, 10, 16, 17, 27, 28):
            jg, tg = j_ra.DlGrant.full(n_prb, mcs), t_ra.DlGrant.full(n_prb, mcs)
            assert jg.tbs == tg.tbs and jg.prb_mask == tg.prb_mask
            assert jg.modulation.name == tg.modulation.name
        jg, tg = j_ra.DlGrant.type2(n_prb, 1, 4, 5), t_ra.DlGrant.type2(n_prb, 1, 4, 5)
        assert (jg.prb_mask, jg.tbs, jg.n_prb) == (tg.prb_mask, tg.tbs, tg.n_prb)
        assert j_ra.rbg_size(n_prb) == t_ra.rbg_size(n_prb)
        for rb_start, l_crb in ((0, 1), (0, n_prb), (2, 3)):
            riv = j_ra.riv_type2(n_prb, rb_start, l_crb)
            assert riv == t_ra.riv_type2(n_prb, rb_start, l_crb)
            assert j_ra.riv_type2_decode(n_prb, riv) == t_ra.riv_type2_decode(n_prb, riv)
    assert t_ra.DlGrant.full(100, 27).tbs == 63776


# -------------------------------------------------------------------- crs
@pytest.mark.parametrize("n_prb,cell_id,sf_idx", [(6, 0, 0), (25, 150, 4), (100, 1, 4),
                                                  (100, 503, 9)])
def test_crs_tables(n_prb, cell_id, sf_idx):
    jc, tc = cells(n_prb, cell_id)
    eq(j_rs.crs_pilots(jc, sf_idx, 0), t_rs.crs_pilots(tc, sf_idx, 0))
    eq(j_rs.crs_mask(jc), t_rs.crs_mask(tc))
    for a, b in zip(j_rs.crs_re_indices(jc, 0), t_rs.crs_re_indices(tc, 0)):
        eq(a, b)
    assert j_rs.crs_sf_symbols(jc, 0) == t_rs.crs_sf_symbols(tc, 0)
    # the estimator's interpolation matrix over the union pilot comb
    allk = np.unique(j_rs.crs_re_indices(jc, 0)[1].reshape(-1))
    eq(j_chest._interp_matrix(allk, jc.ofdm.nof_re), t_chest._interp_matrix(allk, tc.ofdm.nof_re))


# ------------------------------------------------------------------ pdsch
@pytest.mark.parametrize("n_prb,sf_idx,cfi,mcs", [(6, 0, 1, 9), (6, 4, 2, 20), (25, 5, 2, 16),
                                                  (25, 4, 3, 27), (100, 4, 2, 27)])
def test_pdsch_re_indices_and_config(n_prb, sf_idx, cfi, mcs):
    jc, tc = cells(n_prb, 1)
    jg, tg = j_ra.DlGrant.full(n_prb, mcs), t_ra.DlGrant.full(n_prb, mcs)
    ps, pb = j_pdsch.sf_flags(sf_idx)
    assert (ps, pb) == t_pdsch.sf_flags(sf_idx)
    eq(j_pdsch.reserved_mask(jc, cfi, ps, pb), t_pdsch.reserved_mask(tc, cfi, ps, pb))
    eq(j_pdsch.pdsch_re_indices(jc, jg.prb_mask, cfi, ps, pb),
       t_pdsch.pdsch_re_indices(tc, tg.prb_mask, cfi, ps, pb))
    jp = j_pdsch.Pdsch(jc, jg, sf_idx, cfi=cfi, rnti=0x46)
    tp = t_pdsch.Pdsch(tc, tg, sf_idx, cfi=cfi, rnti=0x46)
    eq(jp.re_idx, tp.re_idx)
    assert jp.cinit == tp.cinit
    assert dataclasses.asdict(jp.cfg) == dataclasses.asdict(tp.cfg)
    assert [dataclasses.asdict(g) for g in jp.cfg.groups] == \
        [dataclasses.asdict(g) for g in tp.cfg.groups]


def test_main_path_shapes():
    """The 20 MHz deployment's numbers, from the port's own tables."""
    cell = t_params.Cell(n_prb=100, id=1, nof_ports=1)
    grant = t_dci.Dci1A(rb_start=0, l_crb=100, mcs=27).grant(100)
    cfg = t_pdsch.Pdsch(cell, grant, 4, cfi=2, rnti=0x46).cfg
    assert (cfg.tbs, cfg.G, cfg.seg.C) == (63776, 82800, 11)
    assert [(g.count, g.K, g.E) for g in cfg.groups] == [(5, 5824, 7524), (6, 5824, 7530)]
    assert cell.ofdm.sf_len == 30720 and t_dci.format0_1a_size(100) == 28
    locs = t_pdcch.ue_locations(t_pdcch.Pdcch(cell, 2, 4).n_cce, 0x46, 4)
    locs += [l for l in t_pdcch.common_locations(t_pdcch.Pdcch(cell, 2, 4).n_cce)
             if l not in locs]
    assert len(locs) == 18 and t_pdcch.Location(8, 8) in locs


# ------------------------------------------------------------------- ofdm
@pytest.mark.parametrize("cp", ["norm", "ext"])
@pytest.mark.parametrize("n_prb", PRBS)
def test_ofdm_index_tables(n_prb, cp):
    jc, tc = cells(n_prb, 1, cp=cp)
    for normalize in (False, True):
        jo, to = j_ofdm.Ofdm(jc.ofdm, normalize=normalize), t_ofdm.Ofdm(tc.ofdm, normalize=normalize)
        eq(jo._cp_insert_idx, to._cp_insert_idx)
        eq(jo._cp_strip_idx, to._cp_strip_idx)
        eq(jo._re_to_bin, to._re_to_bin)
        assert jo.dc == to.dc


# ------------------------------------------------------------ pdcch / dci
@pytest.mark.parametrize("n_cce", [6, 21, 41, 84])
def test_search_spaces(n_cce):
    as_tuples = lambda locs: [(l.cce, l.L) for l in locs]
    for rnti in (0x46, 0x1234, 0xFFFF):
        for sf_idx in range(10):
            assert as_tuples(j_pdcch.ue_locations(n_cce, rnti, sf_idx)) == \
                as_tuples(t_pdcch.ue_locations(n_cce, rnti, sf_idx))
            assert j_pdcch.yk(rnti, sf_idx) == t_pdcch.yk(rnti, sf_idx)
        eq(j_pdcch.rnti_mask(rnti), t_pdcch.rnti_mask(rnti))
    assert as_tuples(j_pdcch.common_locations(n_cce)) == as_tuples(t_pdcch.common_locations(n_cce))


@pytest.mark.parametrize("n_prb", PRBS)
def test_dci_format1a(n_prb):
    assert j_dci.format0_1a_size(n_prb) == t_dci.format0_1a_size(n_prb)
    for rb_start, l_crb, mcs, rv in ((0, n_prb, 27, 0), (1, 3, 5, 2), (0, 1, 0, 1)):
        jd = j_dci.Dci1A(rb_start, l_crb, mcs, harq_pid=3, ndi=1, rv=rv, tpc=1)
        td = t_dci.Dci1A(rb_start, l_crb, mcs, harq_pid=3, ndi=1, rv=rv, tpc=1)
        bits = t_dci.pack_format1a(td, n_prb)
        eq(j_dci.pack_format1a(jd, n_prb), bits)
        assert dataclasses.asdict(t_dci.unpack_format1a(bits, n_prb)) == \
            dataclasses.asdict(j_dci.unpack_format1a(bits, n_prb)) == dataclasses.asdict(td)
        jg, tg = jd.grant(n_prb), td.grant(n_prb)
        assert (jg.prb_mask, jg.mcs, jg.rv, jg.tbs) == (tg.prb_mask, tg.mcs, tg.rv, tg.tbs)
        # P/SI/RA-RNTI: TBS from the TPC bit, QPSK
        jg, tg = jd.grant(n_prb, 0xFFFF), td.grant(n_prb, 0xFFFF)
        assert (jg.tbs, jg.modulation.name) == (tg.tbs, tg.modulation.name)
    zeros = np.zeros(t_dci.format0_1a_size(n_prb), np.uint8)
    assert t_dci.unpack_format1a(zeros, n_prb) is None


def test_pcfich_codebook():
    eq(j_pcfich._CFI_CW, t_pcfich._CFI_CW)
    for cid, sf in ((0, 0), (1, 4), (503, 9)):
        eq(j_pcfich._codebook_signed(cid, sf), t_pcfich._codebook_signed(cid, sf))


# -------------------------------------------------------------- pss / sss
def test_sync_sequences():
    for n_id_2 in range(3):
        eq(j_zc.pss_sequence(n_id_2), t_zc.pss_sequence(n_id_2))
        for n_id_1 in (0, 1, 100, 167):
            for sf5 in (False, True):
                eq(j_sss.sss_sequence(n_id_1, n_id_2, sf5), t_sss.sss_sequence(n_id_1, n_id_2, sf5))
    eq(j_zc.zadoff_chu(25, 63), t_zc.zadoff_chu(25, 63))
    eq(j_zc.zadoff_chu(7, 64, 1), t_zc.zadoff_chu(7, 64, 1))


def test_sss_detect_tables():
    eq(j_sss._nid1_table(), t_sss._nid1_table())
    for n_sections in (1, 4):
        for a, b in zip(j_sss._detect_tables(n_sections), t_sss._detect_tables(n_sections)):
            eq(a, b)


@pytest.mark.parametrize("n_prb", PRBS)
def test_pss_replicas_and_filter_bank(n_prb):
    n = t_params.symbol_sz(n_prb)
    for n_id_2 in range(3):
        eq(j_pss.pss_time(n_id_2, n), t_pss.pss_time(n_id_2, n))
    conv_len = 2 * n if n_prb == 100 else 8 * n
    eq(j_pss._pss_filter_bank(n, conv_len), t_pss._pss_filter_bank(n, conv_len))


# ------------------------------------------------------------------- pbch
@pytest.mark.parametrize("cp", ["norm", "ext"])
@pytest.mark.parametrize("n_prb", PRBS)
def test_pbch_tables(n_prb, cp):
    for cid in (0, 1, 2, 503):
        jc, tc = cells(n_prb, cid, cp=cp)
        eq(j_pbch.pbch_re_indices(jc), t_pbch.pbch_re_indices(tc))
        assert j_pbch.e_total(jc) == t_pbch.e_total(tc)
        e = t_pbch.e_total(tc)
        eq(j_pbch._scramble_signed(cid, e), t_pbch._scramble_signed(cid, e))
    for p in (1, 2, 4):
        eq(j_pbch.ant_mask(p), t_pbch.ant_mask(p))
    assert (j_pbch.MIB_LEN, j_pbch.PAYLOAD) == (t_pbch.MIB_LEN, t_pbch.PAYLOAD)


# ------------------------------------------------------------------ dlsch
@pytest.mark.parametrize("tbs,G,Qm", [(1000, 2400, 2), (6200, 14400, 4), (63776, 82800, 6),
                                      (12960, 30000, 6)])
def test_dlsch_groups_and_derm_tables(tbs, G, Qm):
    jcfg, tcfg = j_dlsch.DlschConfig(tbs, G, Qm), t_dlsch.DlschConfig(tbs, G, Qm)
    assert [dataclasses.asdict(g) for g in jcfg.groups] == \
        [dataclasses.asdict(g) for g in tcfg.groups]


# -------------------------------------------------------- rest of the DL
def test_mimo_codebooks():
    """The 2-port and 4-port codebooks, the CDD matrices and every 4-port
    precoder of rank 1-4 (and the Householder matrices are unitary)."""
    for name in ("_W2", "_U2", "_U4", "_W4", "_DFT4", "_CDD4_W"):
        eq(getattr(j_mimo, name), getattr(t_mimo, name))
    assert j_mimo._CB4_COLS == t_mimo._CB4_COLS
    for pmi in range(16):
        w = t_mimo._W4[pmi]
        assert np.allclose(w @ w.conj().T, np.eye(4), atol=1e-6)
        for nl in (1, 2, 3, 4):
            eq(j_mimo.codebook_4port(pmi, nl), t_mimo.codebook_4port(pmi, nl))


@pytest.mark.parametrize("n_prb", (6, 25, 100))
@pytest.mark.parametrize("alg", ["average", "interpolate", "wiener"])
def test_chest_weight_tables(n_prb, alg):
    """The interpolation and Wiener matrices (the latter a complex128
    inverse on the host, P = 400 pilots at 100 PRB) of every port."""
    jc, tc = cells(n_prb, 301, nof_ports=4)
    jt, tt = j_chest.ChestDL(jc, alg)._tables, t_chest.ChestDL(tc, alg)._tables
    for (jsyms, jks, jallk, jw, jtw), (tsyms, tks, tallk, tw, ttw, *_) in zip(jt, tt):
        eq(jsyms, tsyms)
        eq(jks, tks)
        eq(jw, tw)
        if alg == "interpolate":
            eq(jtw, ttw)
        else:
            eq(jallk, tallk)
    pos = np.array([0, 3, 7, 11])
    eq(j_chest._interp_matrix(pos, 14), t_chest._interp_matrix(pos, 14))


def test_phich_spread_tables():
    eq(j_phich._walsh(), t_phich._walsh())
    for cid in (0, 1, 301, 503):
        for sf in range(10):
            eq(j_phich._spread_matrix(cid, sf), t_phich._spread_matrix(cid, sf))


@pytest.mark.parametrize("n_prb", PRBS)
def test_mbsfn_tables(n_prb):
    eq(j_pmch.mbsfn_rs_subcarriers(n_prb), t_pmch.mbsfn_rs_subcarriers(n_prb))
    for area, sf in ((0, 0), (1, 3), (255, 9)):
        eq(j_pmch.mbsfn_rs_values(n_prb, area, sf), t_pmch.mbsfn_rs_values(n_prb, area, sf))
        assert j_pmch.pmch_cinit(sf, area) == t_pmch.pmch_cinit(sf, area)
    jc, tc = cells(n_prb, 1, cp="ext")
    for region in (1, 2):
        eq(j_pmch.pmch_re_indices(jc, region), t_pmch.pmch_re_indices(tc, region))


def test_tdd_special_subframe_tables():
    for name in ("SPECIAL_SF_SYMBOLS", "NOF_HARQ", "K_PUSCH", "K_PHICH"):
        assert getattr(j_tdd, name) == getattr(t_tdd, name)
    assert [[t.value for t in row] for row in j_tdd.UL_DL_CONFIGS] == \
        [[t.value for t in row] for row in t_tdd.UL_DL_CONFIGS]


def test_band_table():
    """The port's own copy of lte_bands.npy holds the same array."""
    eq(np.load(ROOT / "srslte_tpu/phy/common/lte_bands.npy"),
       np.load(ROOT / "srslte_tpu_torch/phy/common/lte_bands.npy"))
    eq(j_band._bands(), t_band._bands())


@pytest.mark.parametrize("n_prb", PRBS)
def test_dci_sizes(n_prb):
    """Every format's size, with the ambiguous-size padding, at 1, 2 and 4
    ports."""
    assert j_dci.AMBIGUOUS_SIZES == t_dci.AMBIGUOUS_SIZES
    for name in ("format0_1a_size", "format1_size", "format1c_size", "_format0_raw_size",
                 "riv_nbits"):
        assert getattr(j_dci, name)(n_prb) == getattr(t_dci, name)(n_prb)
    for ports in (1, 2, 4):
        for name in ("format1b_size", "format1d_size", "format2_size", "format2a_size",
                     "format2b_size"):
            got = getattr(t_dci, name)(n_prb, ports)
            assert got == getattr(j_dci, name)(n_prb, ports)
            assert got not in t_dci.AMBIGUOUS_SIZES
        for name in ("tpmi_bits", "precoding_bits_f2", "precoding_bits_f2a"):
            assert getattr(j_dci, name)(ports) == getattr(t_dci, name)(ports)


def test_sm_path_shapes():
    """The 20 MHz numbers of `chip_smoke.py` phases 13-15, from the port's
    own tables: per codeword of the 2x2 and 4x4 cells TBS 63776 in 11 code
    blocks of K 5824 (G 79200 and 153600), the DCI lengths and candidate
    counts, PMCH at mcs 20 and the DwPTS PDSCH."""
    assert (t_dci.format2_size(100, 2), t_dci.format2a_size(100, 2),
            t_dci.format2_size(100, 4)) == (51, 48, 54)
    d = t_dci.Dci2(rbg_bitmask=(1 << 25) - 1, mcs=(27, 27), pinfo=2)
    g0, g1 = d.grants(100)
    for ports, cls, G, n_cce, n_cand in ((2, t_pdsch.PdschSm, 79200, 50, 18),
                                         (4, t_pdsch.PdschSm4, 153600, 39, 20)):
        cell = t_params.Cell(n_prb=100, id=1, nof_ports=ports)
        p = cls(cell, g0, 4, cfi=2, rnti=0x46, pmi=0, grant1=g1)
        for q in range(2):
            cfg = p.cfg_q(q)
            assert (cfg.tbs, cfg.G, cfg.seg.C, cfg.seg.K1) == (63776, G, 11, 5824)
        pd = t_pdcch.Pdcch(cell, 2, 4)
        locs = t_pdcch.ue_locations(pd.n_cce, 0x46, 4)
        locs += [l for l in t_pdcch.common_locations(pd.n_cce) if l not in locs]
        assert (pd.n_cce, len(locs)) == (n_cce, n_cand)
    pm = t_pmch.Pmch(t_params.Cell(n_prb=100, id=1, cp=t_params.CP.EXT), 1, 3, 20)
    assert (pm.cfg.tbs, pm.cfg.seg.C, pm.cfg.seg.K1) == (39232, 7, 5632)
    grant = dataclasses.replace(t_ra.DlGrant.full(100, 27), is_dwpts=True)
    dw = t_tdd.TddConfig(sf_config=1, ss_config=4).nof_dw
    cfg = t_pdsch.Pdsch(t_params.Cell(n_prb=100, id=1), grant, 1, cfi=2, rnti=0x46,
                        dwpts_symbols=dw).cfg
    assert (dw, cfg.tbs, cfg.seg.C, cfg.seg.K1) == (12, 46888, 8, 5888)


@pytest.mark.parametrize("mcs,bucket", [(20, (39232, 82800, 7, 5632)),
                                        (13, (22920, 55200, 4, 5760)),
                                        (6, (10296, 27600, 2, 5184))])
def test_channel_path_shapes(mcs, bucket):
    """The 20 MHz DL-SCH buckets of `chip_smoke.py` phase 16 (DCI 1A over all
    100 PRB at the fading profiles' mcs), the same in both packages: the SISO
    shapes phase 3 holds the kernel at, none with K < 256."""
    jc, tc = cells(100)
    got = []
    for pk_dci, pk_pdsch, cell in ((j_dci, j_pdsch, jc), (t_dci, t_pdsch, tc)):
        d = pk_dci.Dci1A(rb_start=0, l_crb=100, mcs=mcs)
        cfg = pk_pdsch.Pdsch(cell, d.grant(100), 4, cfi=2, rnti=0x46).cfg
        got.append((cfg.tbs, cfg.G, cfg.seg.C, cfg.seg.K1))
    assert got == [bucket, bucket] and bucket[3] >= 256


# ------------------------------------------------ PUCCH, SRS, PRACH tables
@pytest.mark.parametrize("name", ["polar_q1024.npy", "polar_il_pattern.npy", "ldpc_bg.npz"])
def test_nr_fec_table_copies(name):
    """The port's own copies of the NR FEC tables hold the same arrays."""
    j = np.load(ROOT / "srslte_tpu/phy/fec" / name)
    t = np.load(ROOT / "srslte_tpu_torch/phy/fec" / name)
    if name.endswith(".npz"):
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            eq(j[k], t[k])
    else:
        eq(j, t)


@pytest.mark.parametrize("npz", ["prach_roots.npz", "srs_bw.npz"])
def test_npz_copies(npz):
    """The port's own copies of the JAX package's data files hold the same
    arrays."""
    j = np.load(ROOT / "srslte_tpu/phy/phch" / npz)
    t = np.load(ROOT / "srslte_tpu_torch/phy/phch" / npz)
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        eq(j[k], t[k])


def pucch_cfgs(pkg):
    """Format 1* resources either side of the mixed-PRB threshold, format 2
    inside and above N_RB^(2), format 3."""
    return ([pkg.PucchConfig(f, n, ds, ncs1, nrb2) for f in ("1", "1a", "1b")
             for n, ds, ncs1, nrb2 in ((0, 1, 0, 0), (5, 2, 6, 1), (40, 3, 6, 2), (100, 1, 0, 3))]
            + [pkg.PucchConfig(f, n, 1, ncs1, nrb2) for f in ("2", "2a", "2b")
               for n, ncs1, nrb2 in ((5, 0, 1), (30, 6, 2))]
            + [pkg.PucchConfig("3", n) for n in (0, 7, 23)])


@pytest.mark.parametrize("cp", ["norm", "ext"])
@pytest.mark.parametrize("n_prb,cell_id", [(6, 13), (25, 77), (100, 1)])
def test_pucch_tables(n_prb, cell_id, cp):
    jc, tc = cells(n_prb, cell_id, cp=cp)
    eq(j_pucch.n_cs_cell(jc), t_pucch.n_cs_cell(tc))
    jcp, tcp = j_params.CP(cp), t_params.CP(cp)
    assert j_pucch.f1_syms(jcp) == t_pucch.f1_syms(tcp)
    assert j_pucch.f2_syms(jcp) == t_pucch.f2_syms(tcp)
    for jcfg, tcfg in zip(pucch_cfgs(j_pucch), pucch_cfgs(t_pucch)):
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
        assert jcfg.nof_ack_bits == tcfg.nof_ack_bits
        assert j_pucch.pucch_m(jc, jcfg) == t_pucch.pucch_m(tc, tcfg)
        key = (jcfg.fmt, jcfg.n_pucch, jcfg.delta_shift, jcfg.n_cs_1, jcfg.n_rb_2)
        for sf in (0, 3, 9):
            for ns in (2 * sf, 2 * sf + 1):
                assert j_pucch.pucch_prb(jc, jcfg, ns) == t_pucch.pucch_prb(tc, tcfg, ns)
                for l in range(jc.cp.nsymb):
                    if jcfg.is_format1:
                        assert (j_pucch._alpha_format1(jc, jcfg, ns, l)
                                == t_pucch._alpha_format1(tc, tcfg, ns, l))
                    else:
                        assert (j_pucch._alpha_format2(jc, jcfg, ns, l)
                                == t_pucch._alpha_format2(tc, tcfg, ns, l))
            if jcfg.is_format1:
                for short in (False, True):
                    for a, b in zip(j_pucch._format1_tables(jc, key, sf, short),
                                    t_pucch._format1_tables(tc, key, sf, short)):
                        for x, y in zip(a, b):
                            eq(x, y)
            elif jcfg.fmt == "3":
                for short in (False, True):
                    for a, b in zip(j_pucch._format3_tables(jc, key, sf, short),
                                    t_pucch._format3_tables(tc, key, sf, short)):
                        for x, y in zip(a, b):
                            eq(x, y)
            else:
                for x, y in zip(j_pucch._format2_tables(jc, key, sf),
                                t_pucch._format2_tables(tc, key, sf)):
                    eq(x, y)
            for n in (20, 48):
                eq(j_pucch._f2_scramble_signed(jc, 0x46, sf, n),
                   t_pucch._f2_scramble_signed(tc, 0x46, sf, n))


def test_pucch_block_codes():
    for a in range(1, 14):
        eq(j_pucch._rm20_codebook(a), t_pucch._rm20_codebook(a))
        for m in (0, 1, 2**a - 1, 5 % 2**a):
            bits = ((m >> np.arange(a)) & 1).astype(np.uint8)
            eq(j_pucch.rm20_encode(bits), t_pucch.rm20_encode(bits))
    for bits in ((), (0,), (1,), (0, 0), (0, 1), (1, 0), (1, 1)):
        assert j_pucch._d_ack(bits) == t_pucch._d_ack(bits)


def test_srs_tables():
    for a, b in zip(j_srs._bw_tables(), t_srs._bw_tables()):
        eq(a, b)
    for n_prb in (6, 25, 40, 50, 60, 75, 80, 100):
        assert j_srs._bw_row(n_prb) == t_srs._bw_row(n_prb)
        for b_srs in range(4):
            for bw_cfg in range(8):
                assert (j_srs.srs_bandwidth(n_prb, b_srs, bw_cfg)
                        == t_srs.srs_bandwidth(n_prb, b_srs, bw_cfg))
                for b_hop, i_srs, tti, n_rrc in ((4, 0, 0, 3), (0, 7, 20, 1), (1, 17, 57, 9)):
                    args = (n_prb, b_srs, bw_cfg, n_rrc)
                    kw = dict(b_hop=b_hop, i_srs=i_srs, tti=tti)
                    assert j_srs.srs_k0_prb(*args, **kw) == t_srs.srs_k0_prb(*args, **kw)
                    assert (j_srs.srs_fb(n_prb, b_srs, bw_cfg, b_hop, i_srs, tti)
                            == t_srs.srs_fb(n_prb, b_srs, bw_cfg, b_hop, i_srs, tti))
                    assert (dataclasses.asdict(j_srs.srs_config_from_bw(
                        n_prb, bw_cfg, b_srs, n_rrc, 1, 3, **kw))
                        == dataclasses.asdict(t_srs.srs_config_from_bw(
                            n_prb, bw_cfg, b_srs, n_rrc, 1, 3, **kw)))
    for i_srs in range(0, 700, 7):
        assert j_srs.t_srs(i_srs) == t_srs.t_srs(i_srs)
        assert j_srs.srs_toffset(i_srs) == t_srs.srs_toffset(i_srs)
        for tti in (0, 1, 10, 77):
            assert j_srs.srs_send_tti(i_srs, tti) == t_srs.srs_send_tti(i_srs, tti)
    jc, tc = cells(100, 1)
    cfg = dict(m_srs=96, k0_prb=2, comb=1, n_srs_cs=5)
    js, ts = j_srs.Srs(jc, j_srs.SrsConfig(**cfg)), t_srs.Srs(tc, t_srs.SrsConfig(**cfg))
    eq(js.seq, ts.seq)
    eq(js.k_idx, ts.k_idx)


@pytest.mark.parametrize("kw", [dict(), dict(root_seq_idx=22, zero_corr_cfg=4, high_speed=True),
                                dict(root_seq_idx=3, zero_corr_cfg=2, fmt=4),
                                dict(zero_corr_cfg=7, fmt=2, freq_offset_prb=4),
                                dict(zero_corr_cfg=0, fmt=1)])
def test_prach_tables(kw):
    for n_prb in (6, 25, 100):
        jcfg = j_prach.PrachConfig(j_params.OfdmParams(n_prb), **kw)
        tcfg = t_prach.PrachConfig(t_params.OfdmParams(n_prb), **kw)
        for name in ("nzc", "delta_f_ra", "k", "phi", "n_cs", "shifts_per_root",
                     "preamble_table", "roots", "n_roots", "srate", "n_fft", "n_cp", "n_seq",
                     "n_total", "first_bin"):
            assert getattr(jcfg, name) == getattr(tcfg, name), name
        for u in tcfg.roots:
            eq(j_prach._root_dft(u, tcfg.nzc), t_prach._root_dft(u, tcfg.nzc))
        if n_prb == 6:
            for idx in (0, 31, 63):
                eq(j_prach.prach_gen(jcfg, idx), t_prach.prach_gen(tcfg, idx))


# ------------------------------------------- channel emulator and resampler
def test_channel_and_resampler_tables():
    """The fading profiles, the Jakes parameters a seed gives, the tap
    delays and amplitudes, and the arbitrary-rate resampler's filter bank
    (the port's own copy of arb_polyfilt.npz) equal the reference's."""
    import srslte_tpu.phy.channel.fading as j_fading
    import srslte_tpu.phy.resampling.resampler as j_res
    import srslte_tpu_torch.phy.channel.fading as t_fading
    import srslte_tpu_torch.phy.resampling.resampler as t_res

    assert t_fading.PROFILES == j_fading.PROFILES
    assert t_fading.N_SINUSOIDS == j_fading.N_SINUSOIDS
    for profile in t_fading.PROFILES:
        for seed in (0, 7, 2024):
            j = j_fading.FadingChannel(profile, 70.0, 30_720_000, seed=seed)
            t = t_fading.FadingChannel(profile, 70.0, 30_720_000, seed=seed)
            for a, b in zip(t._jakes + t._taps, j._jakes + j._taps):
                eq(a, b)
            assert t.halo == j.halo
    j = np.load(ROOT / "srslte_tpu/phy/resampling/arb_polyfilt.npz")
    t = np.load(ROOT / "srslte_tpu_torch/phy/resampling/arb_polyfilt.npz")
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        eq(j[k], t[k])
    eq(t_res._arb_polyfilt(), j_res._arb_polyfilt())
    assert (t_res.ARB_N, t_res.ARB_M) == (j_res.ARB_N, j_res.ARB_M)


def test_channel_exports():
    """The port's phy.channel, phy.resampling, phy.io and runtime packages
    export the reference's names."""
    import srslte_tpu.phy.channel as j_ch
    import srslte_tpu.phy.io as j_io
    import srslte_tpu.phy.resampling as j_rs
    import srslte_tpu.runtime as j_rt
    import srslte_tpu_torch.phy.channel as t_ch
    import srslte_tpu_torch.phy.io as t_io
    import srslte_tpu_torch.phy.resampling as t_rs
    import srslte_tpu_torch.runtime as t_rt

    for j, t in ((j_ch, t_ch), (j_io, t_io), (j_rs, t_rs), (j_rt, t_rt)):
        names = {n for n in dir(j) if not n.startswith("_")
                 and getattr(getattr(j, n), "__module__", "").startswith("srslte_tpu")}
        assert names and all(hasattr(t, n) for n in names), (j.__name__, names)


# ------------------------------------------------------------------ NB-IoT
def test_nbiot_table_copies():
    """The port's copies of the NB-IoT tables: TBS and subframe counts, the
    NPSS sequence and replica, the NSSS bank, the NSSS RE order, the NRS
    positions and values, the NPDSCH and NPBCH RE maps."""
    import srslte_tpu.phy.nbiot as j_nb
    import srslte_tpu.phy.nbiot.npbch as j_npbch
    import srslte_tpu.phy.nbiot.npdsch as j_npdsch
    import srslte_tpu.phy.nbiot.nrs as j_nrs
    import srslte_tpu.phy.nbiot.sync as j_nsync
    import srslte_tpu.phy.nbiot.ue as j_nue
    import srslte_tpu_torch.phy.nbiot as t_nb
    import srslte_tpu_torch.phy.nbiot.npbch as t_npbch
    import srslte_tpu_torch.phy.nbiot.npdsch as t_npdsch
    import srslte_tpu_torch.phy.nbiot.nrs as t_nrs
    import srslte_tpu_torch.phy.nbiot.sync as t_nsync
    import srslte_tpu_torch.phy.nbiot.ue as t_nue

    assert t_npdsch.TBS_TABLE_NB == j_npdsch.TBS_TABLE_NB
    assert t_npdsch.NOF_SF_TABLE == j_npdsch.NOF_SF_TABLE
    for i_tbs in range(13):
        for i_sf in range(8):
            if j_npdsch.TBS_TABLE_NB[i_tbs][i_sf]:
                g = t_npdsch.NbDlGrant(i_tbs, i_sf)
                assert (g.tbs, g.nof_sf) == (j_npdsch.NbDlGrant(i_tbs, i_sf).tbs,
                                             j_npdsch.NbDlGrant(i_tbs, i_sf).nof_sf)
    eq(t_nsync.NPSS_COVER, j_nsync.NPSS_COVER)
    assert (t_nsync.NPSS_ROOT, t_nsync.NSSS_LEN) == (j_nsync.NPSS_ROOT, j_nsync.NSSS_LEN)
    eq(t_nsync.npss_sequence(), j_nsync.npss_sequence())
    eq(t_nsync.npss_time(), j_nsync.npss_time())
    eq(t_nsync._nsss_bank(), j_nsync._nsss_bank())
    eq(t_nsync._hadamard128(), j_nsync._hadamard128())
    for nid, fpos in ((0, 0), (257, 3), (503, 2)):
        eq(t_nsync.nsss_sequence(nid, fpos), j_nsync.nsss_sequence(nid, fpos))
    eq(t_nue.nsss_re_order(), j_nue.nsss_re_order())
    assert (t_nue.HOST_PRB, t_nue.NB_RE0, t_nue.SYNC_SYMBOLS) == (
        j_nue.HOST_PRB, j_nue.NB_RE0, j_nue.SYNC_SYMBOLS)
    assert (t_nrs.NRS_SYMBOLS, t_nrs.MAX_PRB) == (j_nrs.NRS_SYMBOLS, j_nrs.MAX_PRB)
    for nid in (0, 1, 257, 503):
        for port in (0, 1):
            eq(t_nrs.nrs_subcarriers(nid, port), j_nrs.nrs_subcarriers(nid, port))
            eq(t_npdsch.npdsch_re_indices(nid, port + 1), j_npdsch.npdsch_re_indices(nid, port + 1))
            assert t_nrs.nrs_reserved_sc(nid, port + 1) == j_nrs.nrs_reserved_sc(nid, port + 1)
        for sf in range(10):
            eq(t_nrs.nrs_values(nid, sf), j_nrs.nrs_values(nid, sf))
        eq(t_npbch.npbch_re_indices(nid), j_npbch.npbch_re_indices(nid))
    assert (t_npbch.MIB_NB_LEN, t_npbch.PAYLOAD, t_npbch.E_TOTAL, t_npbch.E_BLOCK,
            t_npbch.NPBCH_SYMBOLS) == (j_npbch.MIB_NB_LEN, j_npbch.PAYLOAD, j_npbch.E_TOTAL,
                                       j_npbch.E_BLOCK, j_npbch.NPBCH_SYMBOLS)
    assert {n for n in dir(j_nb) if not n.startswith("_")} <= set(dir(t_nb))


def test_sidelink_table_copies():
    """The port's copies of the sidelink tables: the symbol roles, PSSS and
    SSSS (every id), the PSBCH, PSCCH and PSSCH DMRS, the group-hopping
    pattern (integer Gold bits shifted in int64), the TRP index sets and
    bitmaps, and the SCI-0 size at every LTE bandwidth."""
    import srslte_tpu.phy.sidelink as j_sl
    import srslte_tpu.phy.sidelink.common as j_slc
    import srslte_tpu.phy.sidelink.ra_sl as j_slra
    import srslte_tpu_torch.phy.sidelink as t_sl
    import srslte_tpu_torch.phy.sidelink.common as t_slc
    import srslte_tpu_torch.phy.sidelink.ra_sl as t_slra

    for name in ("NRE", "PSBCH_DATA_SYMS", "PSBCH_E_SYMS", "PSSS_SYMS", "SSSS_SYMS",
                 "SL_DMRS_SYMS", "GUARD_SYM", "PSCCH_DATA_SYMS", "PSSCH_DATA_SYMS", "SL_E_SYMS"):
        assert getattr(t_slc, name) == getattr(j_slc, name), name
    for n in range(2):
        eq(t_sl.psss_sequence(n), j_sl.psss_sequence(n))
    eq(np.stack([t_sl.ssss_sequence(n) for n in range(336)]),
       np.stack([j_sl.ssss_sequence(n) for n in range(336)]))
    for n in (0, 1, 15, 16, 167, 168, 335):
        eq(t_slc.psbch_dmrs(n), j_slc.psbch_dmrs(n))
    for cs in (0, 3, 6, 9):
        for n_prb in (1, 2):
            eq(t_slc.pscch_dmrs(cs, n_prb), j_slc.pscch_dmrs(cs, n_prb))
    for n_x_id in (0, 29, 30, 42, 168, 171, 255, 509):
        eq(t_slc._f_gh_pattern(n_x_id), j_slc._f_gh_pattern(n_x_id))
        assert t_slc._f_gh_pattern(n_x_id).dtype == np.int64
        for n_prb in (1, 4, 8, 48):
            eq(t_slc.pssch_dmrs(n_x_id, n_prb), j_slc.pssch_dmrs(n_x_id, n_prb))
    for n in (6, 7, 8):
        for k in range(n + 1):
            assert t_slra.trp_indices_for_k(n, k) == j_slra.trp_indices_for_k(n, k)
        for i in range(1 << n):
            assert t_slra.trp_bitmap(i, n) == j_slra.trp_bitmap(i, n)
    for n_prb in PRBS:
        assert t_sl.sci0_size(n_prb) == j_sl.sci0_size(n_prb)
    assert {n for n in dir(j_sl) if not n.startswith("_")} <= set(dir(t_sl))
