"""The downlink chain, module by module and as a whole, against the JAX package.

eNB encode -> OFDM -> channel estimate -> PCFICH -> PDCCH blind search ->
PDSCH decode, at 6 and 25 PRB on the CPU.  The same numpy inputs (bits from a
seed, noise from a seed) go through both packages.  Floats agree to rtol 1e-4
and atol 1e-5 of the signal's scale (float32 FFTs and sums taken in another
order); hard outputs (CFI, DCI hits and payloads, CRC flags, TB bits where the
CRC passes) agree exactly.  The reference runs its float32 path.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.enb.enb_dl as j_enb
import srslte_tpu.phy.modem.modem as j_modem
import srslte_tpu.phy.phch.dci as j_dci
import srslte_tpu.phy.phch.pcfich as j_pcfich
import srslte_tpu.phy.phch.pdcch as j_pdcch
import srslte_tpu.phy.phch.pdsch as j_pdsch
import srslte_tpu.phy.ue.ue_dl as j_ue
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.enb.enb_dl as t_enb
import srslte_tpu_torch.phy.modem.modem as t_modem
import srslte_tpu_torch.phy.phch.dci as t_dci
import srslte_tpu_torch.phy.phch.pbch as t_pbch
import srslte_tpu_torch.phy.phch.pcfich as t_pcfich
import srslte_tpu_torch.phy.phch.pdcch as t_pdcch
import srslte_tpu_torch.phy.phch.pdsch as t_pdsch
import srslte_tpu_torch.phy.phch.phich as t_phich
import srslte_tpu_torch.phy.ue.ue_dl as t_ue
from srslte_tpu.phy.chest.refsignal_dl import get_crs as j_get_crs
from srslte_tpu.phy.common.scrambling import scramble_bits as j_scramble_bits
from srslte_tpu.phy.common.scrambling import scramble_llr as j_scramble_llr
from srslte_tpu.phy.mimo.mimo import equalize_zf as j_equalize_zf
from srslte_tpu_torch.phy.chest.refsignal_dl import get_crs as t_get_crs
from srslte_tpu_torch.phy.common.scrambling import scramble_bits as t_scramble_bits
from srslte_tpu_torch.phy.common.scrambling import scramble_llr as t_scramble_llr
from srslte_tpu_torch.phy.mimo.mimo import equalize_zf as t_equalize_zf

CPU = "cpu"
RNTI = 0x46
SF_IDX = 4
torch.set_num_threads(1)  # several test workers share the machine's cores

# n_prb -> (cfi, mcs): 64QAM in one code block; 16QAM in two code blocks
CONFIGS = {6: (2, 20), 25: (2, 16)}


def close(got, ref, scale=None):
    """rtol 1e-4, atol 1e-5 of the signal's scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


class Side:
    """One package's objects for a (n_prb, cfi, mcs) deployment."""

    def __init__(self, params, enb, dci, pcfich, pdcch, pdsch, ue, n_prb):
        cfi, mcs = CONFIGS[n_prb]
        self.cfi = cfi
        self.cell = params.Cell(n_prb=n_prb, id=1, nof_ports=1)
        self.dci = dci.Dci1A(rb_start=0, l_crb=n_prb, mcs=mcs)
        self.grant = self.dci.grant(n_prb)
        self.pdsch = pdsch.Pdsch(self.cell, self.grant, SF_IDX, cfi=cfi, rnti=RNTI)
        self.enb = enb.EnbDl(self.cell)
        self.ue = ue.UeDl(self.cell)
        self.pd = pdcch.Pdcch(self.cell, cfi, SF_IDX)
        self.pcfich = pcfich.Pcfich(self.cell, SF_IDX)
        self.dci_bits = dci.pack_format1a(self.dci, n_prb)
        self.dci_len = dci.format0_1a_size(n_prb)
        locs = pdcch.ue_locations(self.pd.n_cce, RNTI, SF_IDX)
        for l in pdcch.common_locations(self.pd.n_cce):
            if l not in locs:
                locs.append(l)
        self.tx_loc = max(locs, key=lambda l: l.L)  # the most robust candidate
        groups = {}
        for l in locs:
            groups.setdefault(l.L, []).append(l)
        self.groups = tuple(tuple(g) for g in groups.values())
        self.mask = pdcch.rnti_mask(RNTI)


@functools.lru_cache(maxsize=None)
def sides(n_prb):
    j = Side(j_params, j_enb, j_dci, j_pcfich, j_pdcch, j_pdsch, j_ue, n_prb)
    t = Side(t_params, t_enb, t_dci, t_pcfich, t_pdcch, t_pdsch, t_ue, n_prb)
    assert (j.tx_loc.cce, j.tx_loc.L) == (t.tx_loc.cce, t.tx_loc.L)
    assert j.pdsch.cfg.seg.C == t.pdsch.cfg.seg.C == {6: 1, 25: 2}[n_prb]
    return j, t


def encode_j(j, bits):
    g = j.enb.put_base(j.enb.empty_grids(bits.shape[:-1]), SF_IDX)
    g = j.enb.put_pcfich(g, SF_IDX, j.cfi)
    g = j.enb.put_pdcch(g, SF_IDX, j.cfi, j.dci_bits, RNTI, j.tx_loc)
    g = j.enb.put_pdsch(g, j.pdsch, jnp.asarray(bits))
    return np.asarray(g), np.asarray(j.enb.gen_signal(g)[..., 0, :])


def encode_t(t, bits):
    g = t.enb.put_base(t.enb.empty_grids(bits.shape[:-1], device=CPU), SF_IDX)
    g = t.enb.put_pcfich(g, SF_IDX, t.cfi)
    g = t.enb.put_pdcch(g, SF_IDX, t.cfi, t.dci_bits, RNTI, t.tx_loc)
    g = t.enb.put_pdsch(g, t.pdsch, bits)
    return g, t.enb.gen_signal(g)[..., 0, :]


@functools.lru_cache(maxsize=None)
def stimulus(n_prb, n_sf, snr_db):
    """(bits, clean signal, received signal) from the reference's encoder;
    noise from numpy at a time-domain SNR, or none for snr_db None."""
    j, _ = sides(n_prb)
    rng = np.random.default_rng(100 * n_prb + n_sf)
    bits = rng.integers(0, 2, (n_sf, j.grant.tbs)).astype(np.uint8)
    _, s = encode_j(j, bits)
    rx = s
    if snr_db is not None:
        sigma = np.sqrt(np.mean(np.abs(s) ** 2) / 10 ** (snr_db / 10) / 2)
        rx = s + sigma * (rng.standard_normal(s.shape) + 1j * rng.standard_normal(s.shape))
    return bits, s, rx.astype(np.complex64)


# --------------------------------------------------------- module by module
@pytest.mark.parametrize("mod", ["BPSK", "QPSK", "QAM16", "QAM64", "QAM256"])
def test_modem(mod):
    jm, tm = j_modem.Modulation[mod], t_modem.Modulation[mod]
    rng = np.random.default_rng(jm.value)
    bits = rng.integers(0, 2, (3, 24 * jm.value)).astype(np.uint8)
    sym = np.asarray(j_modem.modulate(jnp.asarray(bits), jm))
    np.testing.assert_array_equal(t_modem.modulate(bits, tm, device=CPU).numpy(), sym)
    y = (sym + 0.01 * (rng.standard_normal(sym.shape) + 1j * rng.standard_normal(sym.shape))
         ).astype(np.complex64)
    ref = np.asarray(j_modem.demod_soft(jnp.asarray(y), jm))
    got = t_modem.demod_soft(y, tm, device=CPU)
    close(got, ref)
    assert got.shape == (3, 24 * jm.value)
    np.testing.assert_array_equal((got.numpy() > 0), bits)  # positive LLR => bit 1


def test_scrambling_and_equalizer():
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, (2, 500)).astype(np.uint8)
    llr = rng.standard_normal((2, 500)).astype(np.float32)
    np.testing.assert_array_equal(t_scramble_bits(bits, 12345, device=CPU).numpy(),
                                  np.asarray(j_scramble_bits(jnp.asarray(bits), 12345)))
    np.testing.assert_array_equal(t_scramble_llr(llr, 12345, device=CPU).numpy(),
                                  np.asarray(j_scramble_llr(jnp.asarray(llr), 12345)))
    y, h = ((rng.standard_normal((2, 64)) + 1j * rng.standard_normal((2, 64))
             ).astype(np.complex64) for _ in range(2))
    close(t_equalize_zf(torch.as_tensor(y), torch.as_tensor(h)),
          j_equalize_zf(jnp.asarray(y), jnp.asarray(h)))


@pytest.mark.parametrize("n_prb", [6, 25])
def test_enb_encode_and_ofdm(n_prb):
    """Every eNB stage fills the same REs with the same values; the OFDM
    modulator's `ifft * sqrt(N)` and the demodulator's `fft / sqrt(N)` agree
    with the reference and invert each other."""
    j, t = sides(n_prb)
    bits, s_ref, _ = stimulus(n_prb, 2, None)
    g_ref, _ = encode_j(j, bits)
    g, s = encode_t(t, bits)
    close(g, g_ref)
    close(s, s_ref)
    assert s.shape == (2, t.cell.ofdm.sf_len) and s.dtype == torch.complex64
    grid = t.ue.ofdm.rx_sf(s_ref, device=CPU)
    close(grid, np.asarray(j.ue.ofdm.rx_sf(jnp.asarray(s_ref))))
    close(grid, g_ref[:, 0])
    # subframe 0 carries PSS and SSS as well; TDD puts them elsewhere
    close(t.enb.put_base(t.enb.empty_grids((), device=CPU), 0),
          np.asarray(j.enb.put_base(j.enb.empty_grids(), 0)))
    jtdd = j_enb.EnbDl(j_params.Cell(n_prb=n_prb, id=1, frame_type="tdd"))
    ttdd = t_enb.EnbDl(t_params.Cell(n_prb=n_prb, id=1, frame_type="tdd"))
    for sf in (0, 1, 4, 5):
        close(ttdd.put_pss_sss(ttdd.empty_grids((), device=CPU), sf),
              np.asarray(jtdd.put_pss_sss(jtdd.empty_grids(), sf)), scale=1.0)


@pytest.mark.parametrize("normalize", [False, True])
def test_ofdm_tx_rx_one_call(normalize):
    """`ofdm_tx` and `ofdm_rx` (one call each, the modem built inside) on
    one 6 PRB subframe against the reference's, within `close`."""
    from srslte_tpu.phy.ofdm import ofdm_rx as j_ofdm_rx
    from srslte_tpu.phy.ofdm import ofdm_tx as j_ofdm_tx
    from srslte_tpu_torch.phy.ofdm import ofdm_rx, ofdm_tx

    rng = np.random.default_rng(6)
    jp, tp = j_params.OfdmParams(6), t_params.OfdmParams(6)
    grid = (rng.standard_normal((tp.nsymb_sf, tp.nof_re))
            + 1j * rng.standard_normal((tp.nsymb_sf, tp.nof_re))).astype(np.complex64)
    s_ref = np.asarray(j_ofdm_tx(jp, jnp.asarray(grid), normalize=normalize))
    s = ofdm_tx(tp, grid, device=CPU, normalize=normalize)
    assert s.shape == (tp.sf_len,) and s.dtype == torch.complex64
    close(s, s_ref)
    g = ofdm_rx(tp, s_ref, device=CPU, normalize=normalize)
    close(g, np.asarray(j_ofdm_rx(jp, jnp.asarray(s_ref), normalize=normalize)))
    close(g, grid * (1.0 if normalize else tp.symbol_sz))


@pytest.mark.parametrize("n_prb", [6, 25])
def test_chest_dl(n_prb):
    j, t = sides(n_prb)
    _, _, rx = stimulus(n_prb, 3, 12.0)
    gj, cej, ij = j.ue.fft_estimate(jnp.asarray(rx), SF_IDX)
    gt, cet, it = t.ue.fft_estimate(rx, SF_IDX, device=CPU)
    close(gt, gj)
    close(cet, cej)
    assert cet.shape == (3, 1, 14, 12 * n_prb)
    for key in ("noise", "rsrp", "snr"):
        close(it[key], ij[key])
    crs = t_get_crs(gt, t.cell, 0)
    assert crs.shape == (3, 4, 2 * n_prb)  # [S, 2*nprb] per subframe
    close(crs, np.asarray(j_get_crs(gj, j.cell, 0)))


@pytest.mark.parametrize("n_prb", [6, 25])
def test_pcfich(n_prb):
    j, t = sides(n_prb)
    for cfi in (1, 2, 3):
        gj = j.enb.put_pcfich(j.enb.put_base(j.enb.empty_grids((2,)), SF_IDX), SF_IDX, cfi)
        gt = t.enb.put_pcfich(t.enb.put_base(t.enb.empty_grids((2,), device=CPU), SF_IDX),
                              SF_IDX, cfi)
        close(gt, np.asarray(gj))
        ce = np.ones(gt.shape, np.complex64)
        cj, confj = j.pcfich.decode(gj[:, 0], jnp.asarray(ce))
        ct, conft = t.pcfich.decode(gt[:, 0], ce)
        np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
        assert (ct.numpy() == cfi).all() and ct.dtype == torch.int32
        close(conft, confj)


@pytest.mark.parametrize("n_prb", [6, 25])
def test_pdcch_search(n_prb):
    j, t = sides(n_prb)
    _, _, rx = stimulus(n_prb, 2, 10.0)
    gj, cej, _ = j.ue.fft_estimate(jnp.asarray(rx), SF_IDX)
    gt, cet, _ = t.ue.fft_estimate(rx, SF_IDX, device=CPU)
    # candidate LLRs of one aggregation level
    group = t.groups[0]
    close(t.pd._llrs(gt, cet, group), np.asarray(j.pd._llrs(gj, cej, list(j.groups[0]))))
    okj, candj = j.pd._decode_mixed_traced(gj, cej, j.groups, j.dci_len, jnp.asarray(j.mask))
    okt, candt = t.pd._decode_mixed_traced(gt, cet, t.groups, t.dci_len, t.mask)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.any(axis=-1).all()
    np.testing.assert_array_equal(candt.numpy()[okj], np.asarray(candj)[okj])
    # the one-subframe host interface
    hits_j = j.pd.search(gj[0], cej[0], RNTI, j.dci_len)
    hits_t = t.pd.search(gt[0], cet[0], RNTI, t.dci_len)
    assert [(l.cce, l.L) for l, _ in hits_t] == [(l.cce, l.L) for l, _ in hits_j]
    assert (t.tx_loc.cce, t.tx_loc.L) in [(l.cce, l.L) for l, _ in hits_t]
    for (_, bj), (_, bt) in zip(hits_j, hits_t):
        np.testing.assert_array_equal(bt, bj)
    np.testing.assert_array_equal(hits_t[0][1], t.dci_bits)
    assert t_dci.unpack_format1a(hits_t[0][1], n_prb) == t.dci
    assert t.pd.search(gt[0], cet[0], RNTI + 1, t.dci_len) == []


def _run_txd_pdsch(cell):
    grant = t_dci.Dci1A(0, 6, 5).grant(6)
    p = t_pdsch.Pdsch(cell, grant, 4, cfi=2)
    bits = torch.as_tensor(np.random.default_rng(1).integers(0, 2, (2, grant.tbs), dtype=np.uint8))
    g = p.encode(bits, t_enb.EnbDl(cell).empty_grids((2,), device=CPU))
    ce = torch.ones((2, cell.nof_ports, 14, 72), dtype=torch.complex64)
    # every port's channel is 1: the grid received is the ports' sum
    out, ok = p.decode(g.sum(1), ce, 1e-3)
    assert ok.all() and torch.equal(out, bits)


def _run_pdcch(cell):
    pd = t_pdcch.Pdcch(cell, 2, 4)
    loc = t_pdcch.ue_locations(pd.n_cce, RNTI, 4)[0]
    payload = t_dci.pack_format1a(t_dci.Dci1A(0, 6, 5), 6)
    g = pd.encode(t_enb.EnbDl(cell).empty_grids(device=CPU), payload, RNTI, loc)
    hits = pd.search(g.sum(0), torch.ones((cell.nof_ports, 14, 72), dtype=torch.complex64),
                     RNTI, len(payload))
    assert any(l == loc and np.array_equal(b, payload) for l, b in hits)


def _run_pcfich(cell):
    pc = t_pcfich.Pcfich(cell, 4)
    g = pc.encode(t_enb.EnbDl(cell).empty_grids(device=CPU), 3)
    cfi, _ = pc.decode(g.sum(0), torch.ones((cell.nof_ports, 14, 72), dtype=torch.complex64))
    assert int(cfi) == 3


def _run_chest(n_ports, alg):
    cell = t_params.Cell(n_prb=6, id=1, nof_ports=n_ports)
    enb = t_enb.EnbDl(cell)
    s = enb.gen_signal(enb.put_base(enb.empty_grids(device=CPU), 4)).sum(0)
    _, ce, info = t_ue.UeDl(cell, chest_algorithm=alg).fft_estimate(s, 4)
    assert ce.shape == (n_ports, 14, 72)
    jcell = j_params.Cell(n_prb=6, id=1, nof_ports=n_ports)
    _, ce_j, _ = j_ue.UeDl(jcell, chest_algorithm=alg).fft_estimate(jnp.asarray(s.numpy()), 4)
    close(ce, ce_j)
    # a flat channel of 1 per port, no noise: the average is exact
    if alg == "average":
        torch.testing.assert_close(ce, torch.ones_like(ce), rtol=0, atol=1e-4)
        assert float(info["noise"]) < 1e-6


def _run_phich(cell):
    enb = t_enb.EnbDl(cell)
    ack = torch.as_tensor(np.random.default_rng(2).integers(0, 2, (1, 8)))
    g = enb.put_phich(enb.empty_grids(device=CPU), 0, ack)
    hi, _ = t_phich.Phich(cell, 0).decode(g.sum(0), torch.ones((1, 14, 72), dtype=torch.complex64))
    assert torch.equal(hi, ack == 1)


def _run_pbch4(cell):
    mib = t_pbch.Mib(6, "norm", "1", 0)
    g = t_enb.EnbDl(cell).put_pbch(t_enb.EnbDl(cell).empty_grids(device=CPU), mib)
    ok, bits, phase, ports = t_pbch.Pbch(cell).decode(
        g.sum(0), torch.ones((4, 14, 72), dtype=torch.complex64))
    assert ok and (phase, ports) == (0, 4) and t_pbch.Mib.unpack(bits) == mib


_CELL2 = t_params.Cell(n_prb=6, id=1, nof_ports=2)
_CELL4 = t_params.Cell(n_prb=6, id=1, nof_ports=4)


@pytest.mark.parametrize("run", [
    lambda: _run_txd_pdsch(_CELL2),
    lambda: _run_pdcch(_CELL2),
    lambda: _run_pcfich(_CELL2),
    lambda: _run_chest(4, "average"),
    lambda: _run_chest(1, "wiener"),
    lambda: _run_phich(t_params.Cell()),
    lambda: _run_pbch4(_CELL4),
], ids=["pdsch_2port", "pdcch_2port", "pcfich_2port", "chest_4port", "chest_wiener", "put_phich",
        "pbch_4port"])
def test_formerly_unported_branches_run(run):
    """The seven constructions that raised NotImplementedError before the
    rest of the DL was ported now build and run at 6 PRB: each round trip on
    an ideal channel gives back what was sent."""
    run()


# --------------------------------------------------------- the whole slice
@pytest.mark.parametrize("n_prb,n_sf,snr_db", [(6, 4, None), (6, 4, 20.0),
                                               (25, 2, None), (25, 3, 13.0)])
def test_downlink_slice(n_prb, n_sf, snr_db):
    """The slice as a whole, as `chip_smoke.py` drives it: fft_estimate ->
    PCFICH -> blind search -> PDSCH decode on the same received samples.
    Clean, and at an SNR with a few dB of margin over the MCS's threshold so
    that the turbo cascade runs past its first phase."""
    j, t = sides(n_prb)
    bits, _, rx = stimulus(n_prb, n_sf, snr_db)

    gj, cej, ij = j.ue.fft_estimate(jnp.asarray(rx), SF_IDX)
    cfi_j, _ = j.pcfich.decode(gj, cej)
    okj, candj = j.pd._decode_mixed_traced(gj, cej, j.groups, j.dci_len, jnp.asarray(j.mask))
    bj, tbokj = j.pdsch.decode(gj, cej, ij["noise"])

    gt, cet, it = t.ue.fft_estimate(rx, SF_IDX, device=CPU)
    cfi_t, _ = t.pcfich.decode(gt, cet)
    okt, candt = t.pd._decode_mixed_traced(gt, cet, t.groups, t.dci_len, t.mask)
    bt, tbokt = t.pdsch.decode(gt, cet, it["noise"])

    np.testing.assert_array_equal(cfi_t.numpy(), np.asarray(cfi_j))
    assert (cfi_t.numpy() == t.cfi).all()
    okj, tbokj = np.asarray(okj), np.asarray(tbokj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    np.testing.assert_array_equal(candt.numpy()[okj], np.asarray(candj)[okj])
    match = (candt.numpy() == t.dci_bits[None, None, :]).all(-1)
    assert (okt.numpy() & match).any(-1).all()  # the DCI is found in every subframe
    np.testing.assert_array_equal(tbokt.numpy(), tbokj)
    assert tbokj.all()
    np.testing.assert_array_equal(bt.numpy()[tbokj], np.asarray(bj)[tbokj])
    np.testing.assert_array_equal(bt.numpy(), bits)
    if snr_db is None:  # the composed UE entry point gives the same
        b2, ok2, _ = t.ue.decode_pdsch(rx, t.pdsch, device=CPU)
        assert ok2.all() and np.array_equal(b2.numpy(), bits)
