"""PBCH, the MIB decoder, the 2- and 4-port channel estimate and SFBC against
the JAX package, on the CPU.

The same numpy inputs (grids, channels and noise from seeds) go through both
packages.  Bits, CRC flags, frame phases and port counts are equal.  Grids,
channel estimates and SFBC symbols agree to rtol 1e-4 and atol 1e-5 of the
signal's scale (float32 products and sums in another order); the noise,
RSRP and SNR of the estimate to rtol 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.chest.chest_dl as j_chest
import srslte_tpu.phy.common.params as j_params
import srslte_tpu.phy.enb.enb_dl as j_enb
import srslte_tpu.phy.mimo.mimo as j_mimo
import srslte_tpu.phy.phch.pbch as j_pbch
import srslte_tpu.phy.ue.ue_mib as j_mib
import srslte_tpu_torch.phy.chest.chest_dl as t_chest
import srslte_tpu_torch.phy.common.params as t_params
import srslte_tpu_torch.phy.enb.enb_dl as t_enb
import srslte_tpu_torch.phy.mimo.mimo as t_mimo
import srslte_tpu_torch.phy.phch.pbch as t_pbch
import srslte_tpu_torch.phy.ue.ue_mib as t_mib

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


def close(got, ref, scale=None):
    """rtol 1e-4, atol 1e-5 of the signal's scale."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.abs(ref).max() if scale is None else scale
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-5 * scale)


def cells(n_prb, cell_id, nof_ports, cp="norm"):
    return (j_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, cp=j_params.CP(cp)),
            t_params.Cell(n_prb=n_prb, id=cell_id, nof_ports=nof_ports, cp=t_params.CP(cp)))


def cplx(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


# -------------------------------------------------------------------- MIB
def test_mib_pack_unpack():
    for n_prb in (6, 15, 25, 50, 75, 100):
        for length in ("norm", "ext"):
            for res in ("1/6", "1/2", "1", "2"):
                for sfn in (0, 4, 512, 1020):
                    jm = j_pbch.Mib(n_prb, length, res, sfn)
                    tm = t_pbch.Mib(n_prb, length, res, sfn)
                    bits = tm.pack()
                    np.testing.assert_array_equal(bits, jm.pack())
                    assert t_pbch.Mib.unpack(bits) == tm
                    assert j_pbch.Mib.unpack(bits) == jm


# ------------------------------------------------------------------- SFBC
def test_alamouti_2tx():
    rng = np.random.default_rng(0)
    x = cplx(rng, (3, 240))
    close(t_mimo.alamouti_encode_2tx(torch.as_tensor(x)), j_mimo.alamouti_encode_2tx(jnp.asarray(x)))
    y, h0, h1 = cplx(rng, (3, 240)), cplx(rng, (3, 240)), cplx(rng, (3, 240))
    for nv in (0.0, 0.1):
        ref = j_mimo.alamouti_decode_2tx(jnp.asarray(y), jnp.asarray(h0), jnp.asarray(h1), nv)
        got = t_mimo.alamouti_decode_2tx(*map(torch.as_tensor, (y, h0, h1)), nv)
        close(got, ref)
    # a flat channel over each pair gives the symbols back
    tx = t_mimo.alamouti_encode_2tx(torch.as_tensor(x))
    g0, g1 = cplx(rng, (3, 120)).repeat(2, -1), cplx(rng, (3, 120)).repeat(2, -1)
    rx = tx[..., 0, :] * torch.as_tensor(g0) + tx[..., 1, :] * torch.as_tensor(g1)
    close(t_mimo.alamouti_decode_2tx(rx, torch.as_tensor(g0), torch.as_tensor(g1)), x)


# ------------------------------------------------------ 2-port estimate
@pytest.mark.parametrize("n_prb,sf_idx", [(6, 0), (6, 5), (100, 0), (100, 3)])
def test_chest_dl_two_ports(n_prb, sf_idx):
    """Ports 0 and 1 through a 2-port CRS grid with a channel per port and
    noise, against the reference's estimate."""
    jc, tc = cells(n_prb, 301, 2)
    enb = t_enb.EnbDl(tc)
    g = enb.put_base(enb.empty_grids(device=CPU), sf_idx).numpy()  # [2, nsym, nre]
    rng = np.random.default_rng(n_prb + sf_idx)
    h = cplx(rng, (2, 1, 1))
    grid = (g * h).sum(0) + cplx(rng, g.shape[1:], 0.05)
    ce_j, info_j = j_chest.ChestDL(jc).estimate(jnp.asarray(grid), sf_idx)
    ce_t, info_t = t_chest.ChestDL(tc).estimate(torch.as_tensor(grid), sf_idx)
    assert ce_t.shape == (2, 14, 12 * n_prb)
    close(ce_t, ce_j)
    for k in ("noise", "rsrp", "snr"):
        np.testing.assert_allclose(info_t[k].numpy(), np.asarray(info_j[k]), rtol=1e-4)
    # each port's estimate is near its own channel
    for p in range(2):
        assert abs(complex(ce_t[p].mean()) - complex(h[p, 0, 0])) < 0.05 * abs(h[p, 0, 0]) + 0.02


def test_chest_dl_four_ports_raise():
    """Named when a 4-port estimate raised: it now runs, and equals the
    reference's (tolerance as `close`)."""
    jc, tc = cells(6, 1, 4)
    rng = np.random.default_rng(4)
    grid = cplx(rng, (2, 14, 72))
    ce_j, info_j = j_chest.ChestDL(jc).estimate(jnp.asarray(grid), 3)
    ce_t, info_t = t_chest.ChestDL(tc).estimate(torch.as_tensor(grid), 3)
    assert ce_t.shape == (2, 4, 14, 72)
    close(ce_t, ce_j)
    np.testing.assert_allclose(info_t["noise"].numpy(), np.asarray(info_j["noise"]), rtol=1e-4)


# ------------------------------------------------------------------- PBCH
@pytest.mark.parametrize("cp", ["norm", "ext"])
def test_pbch_re_indices(cp):
    for cid in (0, 1, 2, 301):
        jc, tc = cells(6, cid, 1, cp)
        np.testing.assert_array_equal(t_pbch.pbch_re_indices(tc), j_pbch.pbch_re_indices(jc))
        assert t_pbch.e_total(tc) == j_pbch.e_total(jc)


@pytest.mark.parametrize("nof_ports", [1, 2])
def test_pbch_encode_frame(nof_ports):
    jc, tc = cells(6, 301, nof_ports)
    rng = np.random.default_rng(nof_ports)
    grids = cplx(rng, (nof_ports, 14, 72), 0.1)  # what the frame already holds
    for sfn in (0, 1, 2, 3, 517):
        jm = j_pbch.Mib(6, "norm", "1", sfn)
        tm = t_pbch.Mib(6, "norm", "1", sfn)
        ref = j_pbch.Pbch(jc).encode_frame(jm, jnp.asarray(grids))
        got = t_pbch.Pbch(tc).encode_frame(tm, torch.as_tensor(grids))
        close(got, ref)
        # EnbDl.put_pbch is the same call
        close(t_enb.EnbDl(tc).put_pbch(torch.as_tensor(grids), tm), ref)


def test_pbch_four_ports_raise():
    """Named when 4-port PBCH raised: the 4-port burst (SFBC-FSTD) now
    equals the reference's, and a 4-port estimate decodes it with the port
    count 4 found among 12 hypotheses, as the reference does."""
    jc, tc = cells(6, 1, 4)
    jm, tm = j_pbch.Mib(6, "norm", "1", 2), t_pbch.Mib(6, "norm", "1", 2)
    ref = j_pbch.Pbch(jc).encode_frame(jm, jnp.zeros((4, 14, 72), jnp.complex64))
    got = t_pbch.Pbch(tc).encode_frame(tm, torch.zeros((4, 14, 72), dtype=torch.complex64))
    close(got, ref)
    rng = np.random.default_rng(5)
    h = cplx(rng, (4, 1, 1), np.sqrt(0.5))
    grid = ((got.numpy() * h).sum(0) + cplx(rng, (14, 72), 0.03)).astype(np.complex64)
    ce = np.ascontiguousarray(np.broadcast_to(h, (4, 14, 72)).astype(np.complex64))
    ok_j, bits_j, ph_j, p_j = j_pbch.Pbch(jc).decode(jnp.asarray(grid), jnp.asarray(ce))
    ok_t, bits_t, ph_t, p_t = t_pbch.Pbch(tc).decode(torch.as_tensor(grid), torch.as_tensor(ce))
    assert (ok_t, ph_t, p_t) == (bool(ok_j), ph_j, p_j) == (True, 2, 4)
    np.testing.assert_array_equal(bits_t, np.asarray(bits_j))


def pbch_rx(nof_ports, sfn, snr_noise, seed):
    """A received subframe-0 grid of a PBCH sent on nof_ports ports through a
    flat channel per port, and that channel as a 2-port estimate."""
    _, tc = cells(6, 301, nof_ports)
    grids = t_pbch.Pbch(tc).encode_frame(t_pbch.Mib(6, "norm", "1/2", sfn),
                                         torch.zeros((nof_ports, 14, 72), dtype=torch.complex64))
    rng = np.random.default_rng(seed)
    h = cplx(rng, (2, 1, 1), np.sqrt(0.5))
    grid = (grids.numpy() * h[:nof_ports]).sum(0) + cplx(rng, (14, 72), snr_noise)
    ce = np.broadcast_to(h, (2, 14, 72)).astype(np.complex64)
    return grid.astype(np.complex64), np.ascontiguousarray(ce)


@pytest.mark.parametrize("nof_ports", [1, 2])
@pytest.mark.parametrize("phase", [0, 1, 2, 3])
def test_pbch_decode_every_hypothesis(nof_ports, phase):
    """The frame phase and the port count are found, and the bits, flags,
    phase and ports equal the reference's; on noise alone neither passes."""
    jc, tc = cells(6, 301, 2)
    for noise, seed in ((0.05, phase), (0.3, 10 + phase)):
        grid, ce = pbch_rx(nof_ports, 8 + phase, noise, seed)
        ok_j, bits_j, ph_j, p_j = j_pbch.Pbch(jc).decode(jnp.asarray(grid), jnp.asarray(ce))
        ok_t, bits_t, ph_t, p_t = t_pbch.Pbch(tc).decode(torch.as_tensor(grid), torch.as_tensor(ce))
        assert (ok_t, ph_t, p_t) == (bool(ok_j), ph_j, p_j)
        np.testing.assert_array_equal(bits_t, np.asarray(bits_j))
        assert ok_t and (ph_t, p_t) == (phase, nof_ports)
        assert t_pbch.Mib.unpack(bits_t).sfn == 8
    rng = np.random.default_rng(99)
    grid = cplx(rng, (14, 72))
    ce = cplx(rng, (2, 14, 72))
    ok_j, bits_j, _, _ = j_pbch.Pbch(jc).decode(jnp.asarray(grid), jnp.asarray(ce))
    ok_t, bits_t, _, _ = t_pbch.Pbch(tc).decode(torch.as_tensor(grid), torch.as_tensor(ce))
    assert ok_t == bool(ok_j) is False
    np.testing.assert_array_equal(bits_t, np.asarray(bits_j))


@pytest.mark.parametrize("n_prb,nof_ports", [(6, 1), (6, 2), (25, 1)])
def test_ue_mib_decode(n_prb, nof_ports):
    """Subframe 0 of an eNB (CRS of every port, PSS/SSS, PBCH) summed over
    its ports, with noise, through both packages' UeMib."""
    jc, tc = cells(n_prb, 77, nof_ports)
    enb = t_enb.EnbDl(tc)
    mib = t_pbch.Mib(n_prb, "norm", "1", 64 + 2)
    g = enb.put_pbch(enb.put_base(enb.empty_grids(device=CPU), 0), mib)
    s = enb.gen_signal(g).sum(0).numpy()
    rng = np.random.default_rng(n_prb)
    s = (s + cplx(rng, s.shape, 0.02)).astype(np.complex64)
    ref = j_mib.UeMib(77, n_prb).decode(jnp.asarray(s))
    got = t_mib.UeMib(77, n_prb).decode(torch.as_tensor(s))
    assert got[0] and bool(ref[0])
    assert got[1] == t_pbch.Mib(**vars(ref[1])) and got[1].sfn == 64
    assert got[2:] == tuple(ref[2:]) == (2, nof_ports)
    # the JAX eNB's subframe 0 is the port's, within tolerance
    jenb = j_enb.EnbDl(jc)
    jg = jenb.put_pbch(jenb.put_base(jenb.empty_grids(), 0), j_pbch.Mib(n_prb, "norm", "1", 66))
    close(g, jg)
