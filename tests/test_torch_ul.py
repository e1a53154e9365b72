"""The uplink PUSCH chain with UCI, module by module and as a whole, against
the JAX package, on the CPU.

UeUl.encode_pusch -> AWGN -> EnbUl.decode_pusch, with the modules it runs:
SC-FDMA (OFDM with the half-subcarrier shift), DFT precoding, the DMRS
tables, the UL channel estimator, the UCI plans, multiplexing and
de-multiplexing (ACK/RI 1 and 2 bits and the block-coded long form, short
CQI through the (32, O) block code, long CQI through CRC8 + the Viterbi
decoder).  The same numpy inputs go through both packages; the reference
runs its float32 path.  Bits, plans and decisions are equal exactly; complex
and float results agree to the tolerance stated at each test.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.chest.chest_ul as j_chest
import srslte_tpu.phy.chest.refsignal_ul as j_rs
import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.common.scrambling as j_scr
import srslte_tpu.phy.enb.enb_ul as j_enb
import srslte_tpu.phy.fec.block as j_block
import srslte_tpu.phy.ofdm as j_ofdm
import srslte_tpu.phy.phch.dft_precoding as j_dft
import srslte_tpu.phy.phch.pusch as j_pusch
import srslte_tpu.phy.phch.ra_ul as j_ra
import srslte_tpu.phy.phch.uci as j_uci
import srslte_tpu.phy.sync.cfo as j_cfo
import srslte_tpu.phy.ue.ue_ul as j_ue
import srslte_tpu_torch.phy.chest.chest_ul as t_chest
import srslte_tpu_torch.phy.chest.refsignal_ul as t_rs
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.common.scrambling as t_scr
import srslte_tpu_torch.phy.enb.enb_ul as t_enb
import srslte_tpu_torch.phy.fec.block as t_block
import srslte_tpu_torch.phy.ofdm as t_ofdm
import srslte_tpu_torch.phy.phch.dft_precoding as t_dft
import srslte_tpu_torch.phy.phch.pusch as t_pusch
import srslte_tpu_torch.phy.phch.ra_ul as t_ra
import srslte_tpu_torch.phy.phch.uci as t_uci
import srslte_tpu_torch.phy.sync.cfo as t_cfo
import srslte_tpu_torch.phy.ue.ue_ul as t_ue
from srslte_tpu_torch.ops import viterbi_cuda
from srslte_tpu_torch.phy.common.sequence import gold_sequence

CPU = "cpu"
RNTI = 0x46
SF_IDX = 2
torch.set_num_threads(1)  # several test workers share the machine's cores


def close(got, ref, rtol=1e-4, atol_rel=1e-5):
    """float32 FFTs and sums taken in another order: rtol 1e-4 and atol
    1e-5 of the reference's scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol_rel * np.abs(ref).max())


def eq(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def cells(n_prb, cell_id=1):
    return j_params.Cell(n_prb=n_prb, id=cell_id), t_params.Cell(n_prb=n_prb, id=cell_id)


def crandn(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
            ).astype(np.complex64)


# -------------------------------------------------------------- SC-FDMA
@pytest.mark.parametrize("shift", [0.5, -0.5])
def test_ofdm_freq_shift(shift):
    jc, tc = cells(15)
    jo = j_ofdm.Ofdm(jc.ofdm, normalize=True, freq_shift=shift)
    to = t_ofdm.Ofdm(tc.ofdm, normalize=True, freq_shift=shift)
    assert jo.dc == to.dc == 0
    eq(to._shift_buffer, jo._shift_buffer)  # both from float64 phases
    rng = np.random.default_rng(3)
    grid = crandn(rng, (2, 14, jc.ofdm.nof_re))
    close(to.tx_sf(grid, device=CPU), jo.tx_sf(jnp.asarray(grid)))
    samples = crandn(rng, (2, jc.ofdm.sf_len))
    close(to.rx_sf(samples, device=CPU), jo.rx_sf(jnp.asarray(samples)))


def test_cfo_correct():
    rng = np.random.default_rng(4)
    x = crandn(rng, (3, 2048))
    for cfo in (0.2, np.array([0.1, -0.3, 0.05], np.float32)):
        close(t_cfo.cfo_correct(x, cfo, 1536, n0=7, device=CPU),
              j_cfo.cfo_correct(jnp.asarray(x), cfo, 1536, n0=7))


@pytest.mark.parametrize("m", [12, 144, 1152])
def test_dft_precoding(m):
    rng = np.random.default_rng(m)
    x = crandn(rng, (2, 12, m))
    close(t_dft.dft_precode(x, device=CPU), j_dft.dft_precode(jnp.asarray(x)))
    close(t_dft.dft_deprecode(x, device=CPU), j_dft.dft_deprecode(jnp.asarray(x)))
    assert [n for n in range(1, 101) if t_dft.valid_prb(n)] == \
        [n for n in range(1, 101) if j_dft.valid_prb(n)]


def test_ra_ul():
    for mcs in range(29):
        assert t_ra.ul_mcs_modulation(mcs).value == j_ra.ul_mcs_modulation(mcs).value
        for n_prb in (1, 6, 12, 50, 96, 100):
            assert t_ra.ul_tbs(mcs, n_prb) == j_ra.ul_tbs(mcs, n_prb)
    g = t_ra.UlGrant(2, 96, 28)
    assert (g.tbs, g.modulation.bits_per_symbol) == (71112, 6)
    with pytest.raises(ValueError):
        t_ra.UlGrant(0, 7, 5)  # 7 PRB: not a DFT size


# ----------------------------------------------------- DMRS and estimator
@pytest.mark.parametrize("cell_id", [0, 1, 137, 503])
def test_pusch_dmrs_tables(cell_id):
    """Host tables built by each package from its own Gold and Zadoff-Chu
    sequences: equal exactly."""
    jc, tc = cells(100, cell_id)
    for m_prb in (1, 2, 3, 12, 96):
        for sf in (0, 2, 7):
            eq(t_rs.pusch_dmrs(tc, sf, m_prb), j_rs.pusch_dmrs(jc, sf, m_prb))
    eq(t_rs._n_pn_table(cell_id), j_rs._n_pn_table(cell_id))
    assert t_rs.dmrs_symbol(tc) == j_rs.dmrs_symbol(jc) == 3


def test_chest_ul():
    jc, tc = cells(25)
    rng = np.random.default_rng(5)
    grid = crandn(rng, (3, 14, jc.ofdm.nof_re))
    cj, ij = j_chest.ChestUl(jc).estimate(jnp.asarray(grid), SF_IDX, 4, 12)
    ct, it = t_chest.ChestUl(tc).estimate(grid, SF_IDX, 4, 12, device=CPU)
    close(ct, cj)
    close(it["h_dmrs"], ij["h_dmrs"])
    close(it["noise"], ij["noise"])


# ------------------------------------------------------------------ UCI
# (m_sc, n_symb, qm, k_segm, UciCfgUl kwargs)
PLANS = {
    "ack1_cqi30_64qam": (144, 12, 6, 6528, dict(o_ack=1, o_cqi=30)),
    "ack2_ri1_cqi8_16qam": (72, 12, 4, 1000, dict(o_ack=2, o_ri=1, o_cqi=8)),
    "ri2_qpsk": (36, 12, 2, 600, dict(o_ri=2)),
    "ack4_ri3_cqi11_64qam": (144, 12, 6, 5000, dict(o_ack=4, o_ri=3, o_cqi=11)),
    "ack1_cqi30_full_width": (1152, 12, 6, 71424, dict(o_ack=1, o_cqi=30)),
}


@functools.lru_cache(maxsize=None)
def plans(name):
    m_sc, n_symb, qm, k_segm, kw = PLANS[name]
    return (j_uci.uci_plan(m_sc, n_symb, qm, k_segm, j_uci.UciCfgUl(**kw)),
            t_uci.uci_plan(m_sc, n_symb, qm, k_segm, t_uci.UciCfgUl(**kw)))


@pytest.mark.parametrize("name", list(PLANS))
def test_uci_plan(name):
    jp, tp = plans(name)
    for f in ("qm", "g_total", "q_ri", "q_ack", "n_cqi_bits", "g_data", "fill_bitpos",
              "ri_b", "ri_val", "ack_b", "ack_val", "ack_bits_all", "rep_pos", "ph_pos"):
        eq(getattr(tp, f), getattr(jp, f))


def test_block_code():
    rng = np.random.default_rng(6)
    for k in (3, 8, 11):
        bits = rng.integers(0, 2, (4, k)).astype(np.uint8)
        for e in (32, 40, 48, 96):
            eq(t_block.block_encode(bits, e), j_block.block_encode(bits, e))
        # 48: PUCCH format 3 folds its 48 LLRs onto the 32 positions
        for e in (32, 40, 48):
            llr = rng.standard_normal((4, e)).astype(np.float32)
            bj, mj = j_block.block_decode(jnp.asarray(llr), k)
            bt, mt = t_block.block_decode(llr, k, device=CPU)
            eq(bt, bj)
            close(mt, mj, rtol=1e-5)


@pytest.mark.parametrize("name", [n for n in PLANS if n != "ack1_cqi30_full_width"])
def test_uci_mux_scramble_demux(name):
    """mux_stream -> scrambling -> scramble_fixups -> noisy LLRs ->
    descrambling -> demux_llr: streams equal exactly, decisions equal (and
    equal to the payloads sent), metrics and data LLRs to 1e-5 (sums over a
    few LLRs in another order)."""
    jp, tp = plans(name)
    kw = PLANS[name][4]
    jcfg, tcfg = j_uci.UciCfgUl(**kw), t_uci.UciCfgUl(**kw)
    rng = np.random.default_rng(len(name))
    B = 3
    cinit = t_scr.pusch_cinit(RNTI, SF_IDX, 1)
    cqi = rng.integers(0, 2, kw.get("o_cqi", 0)).astype(np.uint8)
    data = rng.integers(0, 2, (B, tp.g_data)).astype(np.uint8)
    src = data
    if tp.n_cqi_bits:
        cq = t_uci.encode_cqi(cqi, tp.n_cqi_bits)
        eq(cq, j_uci.encode_cqi(cqi, jp.n_cqi_bits))
        src = np.concatenate([np.broadcast_to(cq, (B, cq.size)), data], -1)
    pay = {n: rng.integers(0, 2, (B, kw[f"o_{n}"])).astype(np.uint8)
           for n in ("ack", "ri") if kw.get(f"o_{n}")}
    sj = j_uci.mux_stream(jp, jnp.asarray(src), **{k: jnp.asarray(v) for k, v in pay.items()})
    st = t_uci.mux_stream(tp, src, device=CPU, **pay)
    eq(st, sj)
    scr_j = j_uci.scramble_fixups(jp, j_scr.scramble_bits(sj, cinit))
    scr_t = t_uci.scramble_fixups(tp, t_scr.scramble_bits(st, cinit))
    eq(scr_t, scr_j)

    scr = np.asarray(scr_j).astype(np.float32)
    llr_tx = (2 * scr - 1) * 3.0 + rng.standard_normal(scr.shape).astype(np.float32)
    llr = np.asarray(j_scr.scramble_llr(jnp.asarray(llr_tx), cinit))
    c = gold_sequence(cinit, tp.g_total)
    dj = j_uci.demux_llr(jp, jnp.asarray(llr), c, jcfg)
    launches = viterbi_cuda.viterbi_decode.launches
    dt = t_uci.demux_llr(tp, llr, c, tcfg, device=CPU)
    assert viterbi_cuda.viterbi_decode.launches == launches  # plain version on the CPU
    assert set(dt) == set(dj)
    for k in dj:
        if k.endswith("_metric") or k == "data_llr":
            close(dt[k], dj[k], rtol=1e-5, atol_rel=1e-6)
        else:
            eq(dt[k], dj[k])
    for n, p in pay.items():
        eq(dt[n], p)
    if tp.n_cqi_bits:
        eq(dt["cqi"], np.broadcast_to(cqi, (B, cqi.size)))
        if tcfg.o_cqi > 11:
            assert dt["cqi_metric"].tolist() == [1.0] * B  # the CRC8 passes


# --------------------------------------------------------- the whole slice
# (n_prb, (prb_start, n_prb, mcs), UCI kwargs or None, SNR dB)
SLICES = {
    "64qam_ack1_cqi30": (15, (1, 12, 24), dict(o_ack=1, o_cqi=30), 16.0),
    "qpsk_data_only": (15, (0, 6, 5), None, 4.0),
}


@functools.lru_cache(maxsize=None)
def slice_run(name):
    """Both packages through encode -> AWGN (numpy) -> decode, capturing the
    data LLRs each hands to its dlsch_decode; the port also decodes in
    bfloat16."""
    n_prb, (ps, npr, mcs), ucfg, snr_db = SLICES[name]
    jc, tc = cells(n_prb)
    jp = j_pusch.Pusch(jc, j_ra.UlGrant(ps, npr, mcs), SF_IDX, RNTI,
                       j_uci.UciCfgUl(**ucfg) if ucfg else None)
    tp = t_pusch.Pusch(tc, t_ra.UlGrant(ps, npr, mcs), SF_IDX, RNTI,
                       t_uci.UciCfgUl(**ucfg) if ucfg else None)
    rng = np.random.default_rng(npr)
    B = 2
    bits = rng.integers(0, 2, (B, tp.grant.tbs)).astype(np.uint8)
    pay, jpay = {}, {}
    if ucfg:
        pay = dict(ack=rng.integers(0, 2, (B, 1)).astype(np.uint8),
                   cqi=rng.integers(0, 2, ucfg["o_cqi"]).astype(np.uint8))
        jpay = dict(ack=jnp.asarray(pay["ack"]), cqi=pay["cqi"])
    sj = np.asarray(j_ue.UeUl(jc).encode_pusch(jp, jnp.asarray(bits), **jpay))
    st = t_ue.UeUl(tc).encode_pusch(tp, bits, device=CPU, **pay)
    sigma = np.sqrt(np.mean(np.abs(sj) ** 2) / 10 ** (snr_db / 10) / 2)
    rx = (sj + crandn(rng, sj.shape, sigma)).astype(np.complex64)

    captured = {}

    def capture(mod, key):
        real = mod.dlsch_decode

        def dec(llr, *a, **kw):
            captured[key] = np.array(llr)
            return real(llr, *a, **kw)
        return dec

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_pusch, "dlsch_decode", capture(j_pusch, "j"))
        mp.setattr(t_pusch, "dlsch_decode", capture(t_pusch, "t"))
        rj = j_enb.EnbUl(jc).decode_pusch(jnp.asarray(rx), jp)
        rt = t_enb.EnbUl(tc).decode_pusch(torch.as_tensor(rx), tp, device=CPU)
    rb = t_enb.EnbUl(tc).decode_pusch(torch.as_tensor(rx), tp, device=CPU,
                                      siso_dtype=torch.bfloat16)
    return bits, pay, sj, st, rj, rt, rb, captured


@pytest.mark.parametrize("name", list(SLICES))
def test_uplink_slice(name):
    """The slice as a whole: the transmitted samples agree (rtol 1e-4, atol
    1e-5 of their scale: float32 FFTs); the data LLRs entering dlsch_decode
    agree to 1e-4 of their scale (FFT, MMSE division and weighting in float32
    in another order); TB bits, CRC flags, ACK and CQI are equal, and equal
    to what was sent.  The bfloat16 decode is held against the port's own
    float32 one (the reference has no CPU path that reaches its bfloat16
    numerics): the same flags and bits."""
    bits, pay, sj, st, (bj, okj, ij), (bt, okt, it), (bb, okb, ib), cap = slice_run(name)
    close(st, sj)
    close(cap["t"], cap["j"], atol_rel=1e-4)
    eq(okt, okj)
    assert okt.all()
    eq(bt, bj)
    eq(bt, bits)
    close(it["noise"], ij["noise"])
    for k in ("ack", "cqi", "cqi_metric"):
        if k in ij:
            eq(it[k], ij[k])
    if pay:
        eq(it["ack"], pay["ack"])
        eq(it["cqi"], np.broadcast_to(pay["cqi"], (2, pay["cqi"].size)))
        assert it["cqi_metric"].tolist() == [1.0, 1.0]
    eq(okb, okt)
    eq(bb, bt)
    for k in ("ack", "cqi"):
        if k in it:
            eq(ib[k], it[k])


def test_unported_ul_branches_raise():
    """The branches that raised before PUCCH and HARQ were ported now agree
    with the JAX package: UeUl.encode_pucch -> EnbUl.decode_pucch (format
    1a, samples rtol 1e-4 and atol 1e-5 of their scale, the ACK equal, the
    metric within 1e-4), and a PUSCH retransmission at rv 2 through
    Pusch.decode (flags and bits equal, the TB decoded)."""
    import srslte_tpu.phy.phch.pucch as j_pucch
    import srslte_tpu_torch.phy.phch.pucch as t_pucch

    jc, tc = cells(6)
    jq = j_pucch.Pucch(jc, j_pucch.PucchConfig("1a", n_pucch=5), SF_IDX)
    tq = t_pucch.Pucch(tc, t_pucch.PucchConfig("1a", n_pucch=5), SF_IDX)
    sj = np.asarray(j_ue.UeUl(jc).encode_pucch(jq, ack_bits=(1,)))
    st = t_ue.UeUl(tc).encode_pucch(tq, ack_bits=(1,), device=CPU)
    close(st, sj)
    rng = np.random.default_rng(21)
    rx = (sj + crandn(rng, sj.shape, 0.05)).astype(np.complex64)
    oj = j_enb.EnbUl(jc).decode_pucch(jnp.asarray(rx), jq)
    ot = t_enb.EnbUl(tc).decode_pucch(torch.as_tensor(rx), tq, device=CPU)
    eq(ot["ack"], oj["ack"])
    assert ot["ack"].tolist() == [1]
    close(ot["metric"], oj["metric"])

    jp = j_pusch.Pusch(jc, j_ra.UlGrant(0, 6, 5, rv=2), SF_IDX)
    tp = t_pusch.Pusch(tc, t_ra.UlGrant(0, 6, 5, rv=2), SF_IDX)
    bits = rng.integers(0, 2, (2, tp.grant.tbs)).astype(np.uint8)
    sj = np.asarray(j_ue.UeUl(jc).encode_pusch(jp, jnp.asarray(bits)))
    rx = (sj + crandn(rng, sj.shape, 0.05 * np.abs(sj).std())).astype(np.complex64)
    bj, okj, _ = j_enb.EnbUl(jc).decode_pusch(jnp.asarray(rx), jp)
    bt, okt, _ = t_enb.EnbUl(tc).decode_pusch(torch.as_tensor(rx), tp, device=CPU)
    eq(okt, okj)
    assert okt.all()
    eq(bt, bj)
    eq(bt, bits)
