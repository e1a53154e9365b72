"""MIMO against the JAX package on the CPU: precoding and detection (2-layer
CDD / codebook, 4-port rank 1-4, SFBC-FSTD, 1x1 MMSE), the DL channel
estimate with every algorithm at 1, 2 and 4 ports, the transmit-diversity
PDSCH, `PdschSm` and `PdschSm4`, and the 2x2 SM downlink slice as a whole
(phase 13 of `chip_smoke.py` at 15 PRB).

The same numpy inputs (from seeds) go through both packages.  Symbols, LLRs,
grids and channel estimates agree to rtol 1e-4 and atol 1e-5 of the
signal's scale (float32 products and sums in another order; the 4-layer
detector solves by another LU); noise estimates to rtol 1e-4.  CFI, DCI
hits, HI decisions, decoded bits and CRC flags are equal.  The CDD phases
are the reference's float32 values bit for bit.  Every MMSE test runs a
batch of subframes with a different noise value in each, since the
reference regularises with one mean over the whole batch.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.chest.chest_dl as j_chest
import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.enb.enb_dl as j_enb
import srslte_tpu.phy.mimo.mimo as j_mimo
import srslte_tpu.phy.modem.modem as j_modem
import srslte_tpu.phy.phch.dci as j_dci
import srslte_tpu.phy.phch.pcfich as j_pcfich
import srslte_tpu.phy.phch.pdcch as j_pdcch
import srslte_tpu.phy.phch.pdsch as j_pdsch
import srslte_tpu.phy.phch.phich as j_phich
import srslte_tpu.phy.phch.ra as j_ra
import srslte_tpu.phy.ue.ue_dl as j_ue
import srslte_tpu_torch.phy.chest.chest_dl as t_chest
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.enb.enb_dl as t_enb
import srslte_tpu_torch.phy.mimo.mimo as t_mimo
import srslte_tpu_torch.phy.phch.dci as t_dci
import srslte_tpu_torch.phy.phch.pcfich as t_pcfich
import srslte_tpu_torch.phy.phch.pdcch as t_pdcch
import srslte_tpu_torch.phy.phch.pdsch as t_pdsch
import srslte_tpu_torch.phy.phch.phich as t_phich
import srslte_tpu_torch.phy.phch.ra as t_ra
import srslte_tpu_torch.phy.ue.ue_dl as t_ue
from srslte_tpu.phy.common.scrambling import scramble_llr as j_scramble_llr

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


def close(got, ref, scale=None):
    """rtol 1e-4, atol 1e-5 of the signal's scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


def cells(n_prb, cell_id, nof_ports, **kw):
    return (j_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, **kw),
            t_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, **kw))


def both(fn_j, fn_t, *arrays, **kw):
    """fn_j on jnp arrays and fn_t on tensors of the same numpy inputs."""
    return (fn_j(*map(jnp.asarray, arrays), **kw),
            fn_t(*map(torch.as_tensor, arrays), **kw))


# ------------------------------------------------------------------ precoding
def test_cdd_phases_bit_exact():
    """The CDD phases are the reference's float32 values, not an exact +-1
    (up to 3.3e-3 off at 100 PRB's 13,200 REs)."""
    for n in (12, 1200, 13200):
        ref = np.asarray(jnp.exp(-1j * jnp.pi * jnp.arange(n)).astype(jnp.complex64))
        np.testing.assert_array_equal(t_mimo._cdd2_phase(n), ref)
        i = jnp.arange(n)
        ref4 = np.asarray(jnp.exp(-2j * jnp.pi * i[None, :] * jnp.arange(4)[:, None] / 4))
        np.testing.assert_array_equal(t_mimo._cdd4_phase(n), ref4)
    p = t_mimo._cdd2_phase(13200)
    assert np.abs(p - np.sign(p.real)).max() > 1e-3


@pytest.mark.parametrize("pmi", [None, 0, 1, 2])
def test_sm_2layer(pmi):
    rng = np.random.default_rng(0 if pmi is None else pmi + 1)
    n = 600
    x = cplx(rng, (3, 2, n))
    pj, pt = both(j_mimo.precode_sm_2layer, t_mimo.precode_sm_2layer, x, pmi=pmi)
    close(pt, pj)
    y, h = cplx(rng, (3, 2, n)), cplx(rng, (3, 2, 2, n))
    nv = np.array([0.01, 0.05, 0.2], np.float32)  # one per subframe: the mean regularises
    (xj, gj), (xt, gt) = both(j_mimo.mmse_sm_2layer, t_mimo.mmse_sm_2layer, y, h, nv, pmi=pmi)
    close(xt, xj)
    close(gt, gj)
    # the layers come back through a constant channel (the reference's test)
    hc = np.broadcast_to(cplx(rng, (2, 2, 1)), (2, 2, n)).astype(np.complex64)
    yc = np.einsum("rkn,bkn->brn", hc, pt.numpy())
    xr, _ = t_mimo.mmse_sm_2layer(torch.as_tensor(yc), torch.as_tensor(hc), 1e-4, pmi)
    np.testing.assert_allclose(xr.numpy(), x, atol=2e-2)


@pytest.mark.parametrize("pmi,nl", [(None, 4), (0, 4), (5, 4), (11, 4), (15, 4), (3, 1),
                                    (7, 2), (9, 3)])
def test_sm_4port(pmi, nl):
    rng = np.random.default_rng(nl * 17 + (pmi or 0))
    n = 96
    x = cplx(rng, (2, nl, n))
    pj, pt = both(j_mimo.precode_sm_4port, t_mimo.precode_sm_4port, x, pmi=pmi)
    close(pt, pj)
    y, h = cplx(rng, (2, 4, n)), cplx(rng, (2, 4, 4, n))
    nv = np.array([0.02, 0.1], np.float32)
    (xj, gj), (xt, gt) = both(j_mimo.mmse_sm_4port, t_mimo.mmse_sm_4port, y, h, nv, pmi=pmi,
                              n_layers=nl)
    close(xt, xj)
    close(gt, gj)
    # a well-conditioned 4x4 channel gives the layers back (the reference's test)
    H = (cplx(rng, (4, 4)) / np.sqrt(2) + 2 * np.eye(4)).astype(np.complex64)
    yc = np.einsum("rp,bpn->brn", H, pt.numpy())
    hc = np.broadcast_to(H[:, :, None], (4, 4, n)).astype(np.complex64)
    xr, gr = t_mimo.mmse_sm_4port(torch.as_tensor(yc), torch.as_tensor(hc), 1e-5, pmi, nl)
    np.testing.assert_allclose(xr.numpy(), x, atol=0.05)
    assert (gr > 0).all()


@pytest.mark.parametrize("n", [48, 50])
def test_sfbc_fstd(n):
    """4-port SFBC-FSTD, with the 2-RE tail of n % 4 == 2."""
    rng = np.random.default_rng(n)
    x = cplx(rng, (3, n))
    ej, et = both(j_mimo.alamouti_encode_4tx, t_mimo.alamouti_encode_4tx, x)
    close(et, ej)
    y, h = cplx(rng, (3, n)), cplx(rng, (3, 4, n))
    (xj, gj), (xt, gt) = both(j_mimo.alamouti_decode_4tx, t_mimo.alamouti_decode_4tx, y, h,
                              noise_var=0.1)
    close(xt, xj)
    close(gt, gj)
    hc = np.broadcast_to(cplx(rng, (4, 1)), (3, 4, n)).astype(np.complex64)
    yc = (hc * et.numpy()).sum(-2).astype(np.complex64)
    xr, _ = t_mimo.alamouti_decode_4tx(torch.as_tensor(yc), torch.as_tensor(hc))
    np.testing.assert_allclose(xr.numpy(), x, atol=1e-4)


def test_equalize_mmse():
    rng = np.random.default_rng(1)
    y, h = cplx(rng, (2, 100)), cplx(rng, (2, 100))
    nv = np.array([[0.1], [0.3]], np.float32)
    rj, rt = both(j_mimo.equalize_mmse, t_mimo.equalize_mmse, y, h, nv)
    close(rt, rj)
    x = cplx(rng, 100)
    hc = (0.5 + 0.3j) * np.ones(100, np.complex64)
    out = t_mimo.equalize_mmse(torch.as_tensor(x * hc), torch.as_tensor(hc), 1e-6)
    np.testing.assert_allclose(out.numpy(), x, atol=1e-3)


# ------------------------------------------------------------- channel estimate
@pytest.mark.parametrize("ports", [1, 2, 4])
@pytest.mark.parametrize("alg", ["average", "interpolate", "wiener"])
def test_chest_dl(ports, alg):
    """Subframes of every port's CRS through a frequency-selective channel
    per port and rx antenna, with noise: the estimate, noise, RSRP and SNR
    of both packages, over a leading rx axis."""
    jc, tc = cells(15, 7, ports)
    o = tc.ofdm
    enb = t_enb.EnbDl(tc)
    g = enb.put_base(enb.empty_grids((2,), device=CPU), 3).numpy()  # [2, ports, nsym, nre]
    rng = np.random.default_rng(ports)
    k = np.arange(o.nof_re)
    taps = cplx(rng, (2, ports, 2), 0.5)  # 2 rx, a 2-tap channel per port
    h = taps[..., :1] + taps[..., 1:] * np.exp(-2j * np.pi * k * 3 / o.symbol_sz)
    rx = np.einsum("rpk,bpsk->brsk", h, g) + cplx(rng, (2, 2, o.nsymb_sf, o.nof_re), 0.03)
    rx = rx.astype(np.complex64)
    ce_j, info_j = j_chest.ChestDL(jc, alg).estimate(jnp.asarray(rx), 3)
    ce_t, info_t = t_chest.ChestDL(tc, alg).estimate(torch.as_tensor(rx), 3)
    assert ce_t.shape == (2, 2, ports, o.nsymb_sf, o.nof_re)
    close(ce_t, ce_j)
    for key in ("noise", "rsrp", "snr"):
        np.testing.assert_allclose(info_t[key].numpy(), np.asarray(info_j[key]), rtol=1e-4)
    # every estimate is near the channel it estimates
    err = np.mean(np.abs(ce_t.numpy()[:, :, :, 5] - h[None]) ** 2) / np.mean(np.abs(h) ** 2)
    assert err < 0.05, err


def test_chest_selective_channel_and_noise():
    """The reference's selective-channel test: a 2-tap channel with AWGN,
    estimate error below 1 % for "average" and "interpolate", and the noise
    estimate within 5x of the truth."""
    rng = np.random.default_rng(0)
    jc, tc = cells(25, 3, 1)
    o = tc.ofdm
    k = np.arange(o.nof_re)
    h = (1.0 + 0.5 * np.exp(-2j * np.pi * k * 4 / o.symbol_sz)).astype(np.complex64)
    sigma = 0.05
    enb = t_enb.EnbDl(tc)
    grid = enb.put_base(enb.empty_grids(device=CPU), 0).numpy()[0] * h
    grid = (grid + cplx(rng, grid.shape, sigma / np.sqrt(2))).astype(np.complex64)
    for alg in ("average", "interpolate"):
        ce_t, info_t = t_chest.ChestDL(tc, alg).estimate(torch.as_tensor(grid), 0)
        ce_j, _ = j_chest.ChestDL(jc, alg).estimate(jnp.asarray(grid), 0)
        close(ce_t, ce_j)
        err = np.mean(np.abs(ce_t.numpy()[0, 0] - h) ** 2) / np.mean(np.abs(h) ** 2)
        assert err < 0.01, (alg, err)
        assert 0.2 * sigma**2 < float(info_t["noise"]) < 5 * sigma**2


# ------------------------------------------------------------------- PDSCH
def per_port_channel(rng, ports, nrx=1):
    return (cplx(rng, (nrx, ports), np.sqrt(0.5)) + np.eye(nrx, ports)).astype(np.complex64)


@pytest.mark.parametrize("ports", [2, 4])
def test_pdsch_transmit_diversity(ports):
    """SFBC (2 ports) and SFBC-FSTD (4 ports) PDSCH: the grids, then two
    noisy subframes through a flat channel per port decoded by both."""
    jc, tc = cells(15, 11, ports)
    jg, tg = j_ra.DlGrant.full(15, 16), t_ra.DlGrant.full(15, 16)
    jp = j_pdsch.Pdsch(jc, jg, 3, cfi=2, rnti=0x77)
    tp = t_pdsch.Pdsch(tc, tg, 3, cfi=2, rnti=0x77)
    rng = np.random.default_rng(ports)
    bits = rng.integers(0, 2, (2, tg.tbs)).astype(np.uint8)
    o = tc.ofdm
    grids = cplx(rng, (2, ports, o.nsymb_sf, o.nof_re), 0.1)  # what the grids already hold
    gj = jp.encode(jnp.asarray(bits), jnp.asarray(grids))
    gt = tp.encode(torch.as_tensor(bits), torch.as_tensor(grids))
    close(gt, gj)
    h = per_port_channel(rng, ports)[0]
    y = np.einsum("p,bpsk->bsk", h, gt.numpy()) + cplx(rng, (2, o.nsymb_sf, o.nof_re), 0.05)
    ce = np.broadcast_to(h[:, None, None], (2, ports, o.nsymb_sf, o.nof_re)).astype(np.complex64)
    nv = np.array([0.004, 0.006], np.float32)
    bj, okj = jp.decode(jnp.asarray(y.astype(np.complex64)), jnp.asarray(ce), jnp.asarray(nv))
    bt, okt = tp.decode(torch.as_tensor(y.astype(np.complex64)), torch.as_tensor(ce),
                        torch.as_tensor(nv))
    np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
    assert okt.all()
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    np.testing.assert_array_equal(bt.numpy(), bits)


def sm_reference_llrs(jp, y, h, nv, ports):
    """The reference's decode2 front end, composed of its own functions: the
    soft bits that its DL-SCH decode receives."""
    y, h = jnp.asarray(y), jnp.asarray(h)
    idx = jnp.asarray(jp.re_idx)
    y = y.reshape(y.shape[:-2] + (-1,))[..., idx]
    h = h.reshape(h.shape[:-2] + (-1,))[..., idx]
    nvm = jnp.mean(jnp.asarray(nv))
    if ports == 2:
        xhat, gain = j_mimo.mmse_sm_2layer(y, h, nvm[None], jp.pmi)
        syms = [(xhat[..., q, :], gain[..., q, :]) for q in range(2)]
    else:
        xhat, gain = j_mimo.mmse_sm_4port(y, h, nvm[None], jp.pmi, n_layers=4)
        syms = [tuple(jnp.stack([a[..., 2 * q, :], a[..., 2 * q + 1, :]], -1)
                      .reshape(a.shape[:-2] + (-1,)) for a in (xhat, gain)) for q in range(2)]
    out = []
    for q, (x, g) in enumerate(syms):
        mod = jp.grant_q(q).modulation
        llr = j_modem.demod_soft(x, mod)
        llr = llr * jnp.repeat(g / jnp.maximum(nvm, 1e-9), mod.bits_per_symbol, axis=-1)
        out.append(j_scramble_llr(llr, jp.cinit_q(q)))
    return out


@pytest.mark.parametrize("ports,pmi", [(2, None), (4, None), (4, 0)])
def test_pdsch_sm(ports, pmi):
    """encode2 grids; then two noisy subframes (another noise value in
    each) through a coupled channel: soft bits of both codewords against
    the reference's front end, the bits sent decoded, and (CDD) the
    reference's decode2 bits and CRC flags.  TM4 at 2 ports runs in the
    slice test; a JAX decode2 compilation costs about 12 s."""
    jc, tc = cells(15, 5, ports)
    jcls, tcls = ((j_pdsch.PdschSm, t_pdsch.PdschSm) if ports == 2
                  else (j_pdsch.PdschSm4, t_pdsch.PdschSm4))
    jg = (j_ra.DlGrant.full(15, 12), j_ra.DlGrant.full(15, 7))
    tg = (t_ra.DlGrant.full(15, 12), t_ra.DlGrant.full(15, 7))
    jp = jcls(jc, jg[0], 2, cfi=2, rnti=0x61, pmi=pmi, grant1=jg[1])
    tp = tcls(tc, tg[0], 2, cfi=2, rnti=0x61, pmi=pmi, grant1=tg[1])
    for q in range(2):
        assert dataclasses.astuple(tp.cfg_q(q))[:4] == dataclasses.astuple(jp.cfg_q(q))[:4]
    rng = np.random.default_rng(4 + ports)
    b0 = rng.integers(0, 2, (2, tg[0].tbs)).astype(np.uint8)
    b1 = rng.integers(0, 2, (2, tg[1].tbs)).astype(np.uint8)
    o = tc.ofdm
    grids = np.zeros((2, ports, o.nsymb_sf, o.nof_re), np.complex64)
    gj = jp.encode2(jnp.asarray(b0), jnp.asarray(b1), jnp.asarray(grids))
    gt = tp.encode2(torch.as_tensor(b0), torch.as_tensor(b1), torch.as_tensor(grids))
    close(gt, gj)
    H = (np.eye(ports) + 0.3 * cplx(rng, (ports, ports))).astype(np.complex64)
    rx = np.einsum("rp,bpsk->brsk", H, gt.numpy())
    rx = (rx + cplx(rng, rx.shape, 0.05)).astype(np.complex64)
    ce = np.ascontiguousarray(np.broadcast_to(H[None, :, :, None, None], (2, ports, ports)
                                              + (o.nsymb_sf, o.nof_re))).astype(np.complex64)
    nv = np.array([0.004, 0.006], np.float32)
    ref = sm_reference_llrs(jp, rx, ce, nv, ports)
    got = tp.soft_bits2(torch.as_tensor(rx), torch.as_tensor(ce), torch.as_tensor(nv))
    for q in range(2):
        close(got[q], ref[q])
    out_t = tp.decode2(torch.as_tensor(rx), torch.as_tensor(ce), torch.as_tensor(nv))
    for (bt, okt), bits in zip(out_t, (b0, b1)):
        assert okt.all()
        np.testing.assert_array_equal(bt.numpy(), bits)
    if pmi is None:
        out_j = jp.decode2(jnp.asarray(rx), jnp.asarray(ce), jnp.asarray(nv))
        for (bj, okj), (bt, okt) in zip(out_j, out_t):
            np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
            np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))


# ------------------------------------------------------------ the whole slice
SLICE_PRB, SLICE_SF, SLICE_CFI, SLICE_RNTI = 15, 4, 2, 0x46


def slice_side(params, enb, dci, pcfich, pdcch, pdsch, phich, ue):
    """One package's objects for the 2x2 TM4 deployment at 15 PRB."""
    cell = params.Cell(n_prb=SLICE_PRB, id=1, nof_ports=2)
    d = dci.Dci2(rbg_bitmask=(1 << 8) - 1, mcs=(16, 16), pinfo=2)
    g0, g1 = d.grants(SLICE_PRB)
    side = dict(cell=cell, dci=d, enb=enb.EnbDl(cell), ue=ue.UeDl(cell),
                pcfich=pcfich.Pcfich(cell, SLICE_SF), phich=phich.Phich(cell, SLICE_SF),
                pd=pdcch.Pdcch(cell, SLICE_CFI, SLICE_SF),
                sm=pdsch.PdschSm(cell, g0, SLICE_SF, cfi=SLICE_CFI, rnti=SLICE_RNTI,
                                 pmi=d.pinfo - 1, grant1=g1),
                payload=dci.pack_format2(d, SLICE_PRB, 2))
    locs = pdcch.ue_locations(side["pd"].n_cce, SLICE_RNTI, SLICE_SF)
    top = max(l.L for l in locs)  # L=8 as phase 13 where the control region has room
    side["loc"] = [l for l in locs if l.L == top][0]
    locs += [l for l in pdcch.common_locations(side["pd"].n_cce) if l not in locs]
    side["groups"] = tuple(tuple(l for l in locs if l.L == L) for L in sorted({l.L for l in locs}))
    return side


@pytest.mark.parametrize("snr_noise", [None, 0.02])
def test_sm_downlink_slice(snr_noise):
    """Phase 13's chain at 15 PRB: the eNB (CRS, PCFICH, a random ACK / NACK
    / off PHICH pattern, DCI 2 at the first UE-specific location of the
    highest level (L=4: 15 PRB have no room for L=8 at CFI 2), both
    TBs through PdschSm at TM4) in both packages, the 2x2 channel of the
    reference's DCI test, then UeDl.fft_estimate on both rx antennas,
    PCFICH, the blind search and PHICH on rx 0, and decode2 with rx 0's
    noise, on two subframes."""
    j = slice_side(j_params, j_enb, j_dci, j_pcfich, j_pdcch, j_pdsch, j_phich, j_ue)
    t = slice_side(t_params, t_enb, t_dci, t_pcfich, t_pdcch, t_pdsch, t_phich, t_ue)
    rng = np.random.default_rng(21)
    b0, b1 = rng.integers(0, 2, (2, 2, t["sm"].cfg.tbs)).astype(np.uint8)
    ack = rng.integers(-1, 2, (2, t["phich"].ngroups, 8)).astype(np.int32)

    def enb_grids(s, lib, asarray):
        enb = s["enb"]
        g = enb.put_base(enb.empty_grids((2,)) if lib == "j" else
                         enb.empty_grids((2,), device=CPU), SLICE_SF)
        g = enb.put_pcfich(g, SLICE_SF, SLICE_CFI)
        g = enb.put_phich(g, SLICE_SF, asarray(ack))
        g = enb.put_pdcch(g, SLICE_SF, SLICE_CFI, s["payload"], SLICE_RNTI, s["loc"])
        return s["sm"].encode2(asarray(b0), asarray(b1), g)

    gj = enb_grids(j, "j", jnp.asarray)
    gt = enb_grids(t, "t", torch.as_tensor)
    close(gt, gj)
    H = np.array([[1.0, 0.3 + 0.2j], [0.25 - 0.3j, 0.9]], np.complex64)
    rx = np.einsum("rp,bps->brs", H, t["enb"].gen_signal(gt).numpy())
    if snr_noise is not None:
        rx = rx + cplx(np.random.default_rng(5), rx.shape, snr_noise)
    rx = rx.astype(np.complex64)

    grid_j, ce_j, info_j = j["ue"].fft_estimate(jnp.asarray(rx), SLICE_SF)
    grid_t, ce_t, info_t = t["ue"].fft_estimate(torch.as_tensor(rx), SLICE_SF)
    close(ce_t, ce_j)
    cfi_j, _ = j["pcfich"].decode(grid_j[:, 0], ce_j[:, 0])
    cfi_t, _ = t["pcfich"].decode(grid_t[:, 0], ce_t[:, 0])
    np.testing.assert_array_equal(cfi_t.numpy(), np.asarray(cfi_j))
    assert (cfi_t == SLICE_CFI).all()
    ok_j, cand_j = j["pd"]._decode_mixed_traced(grid_j[:, 0], ce_j[:, 0], j["groups"],
                                                len(j["payload"]),
                                                jnp.asarray(j_pdcch.rnti_mask(SLICE_RNTI)))
    ok_t, cand_t = t["pd"]._decode_mixed_traced(grid_t[:, 0], ce_t[:, 0], t["groups"],
                                                len(t["payload"]),
                                                t_pdcch.rnti_mask(SLICE_RNTI))
    ok_j = np.asarray(ok_j)
    np.testing.assert_array_equal(ok_t.numpy(), ok_j)
    np.testing.assert_array_equal(cand_t.numpy()[ok_j], np.asarray(cand_j)[ok_j])
    for sf in range(2):  # the grants rebuilt from the DCI found
        found = cand_t.numpy()[sf][ok_t.numpy()[sf]][0]
        assert t_dci.unpack_format2(found, SLICE_PRB, 2) == t["dci"]
    hi_j, m_j = j["phich"].decode(grid_j[:, 0], ce_j[:, 0])
    hi_t, m_t = t["phich"].decode(grid_t[:, 0], ce_t[:, 0])
    close(m_t, m_j)
    # decisions on the sent sequences (an off one's metric is noise about 0)
    on = ack >= 0
    np.testing.assert_array_equal(hi_t.numpy()[on], np.asarray(hi_j)[on])
    assert (hi_t.numpy() == (ack == 1))[on].all()
    out_j = j["sm"].decode2(grid_j, ce_j, info_j["noise"][:, 0])
    out_t = t["sm"].decode2(grid_t, ce_t, info_t["noise"][:, 0])
    for (bj, okj), (bt, okt), bits in zip(out_j, out_t, (b0, b1)):
        np.testing.assert_array_equal(okt.numpy(), np.asarray(okj))
        assert okt.all()
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
        np.testing.assert_array_equal(bt.numpy(), bits)
