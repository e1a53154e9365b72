"""FEC parity: the port's coders and decoders against the JAX package, on the CPU.

Most parities here are against the reference's float32 path (the XLA scans
it runs off-TPU, and its Pallas kernels in interpret mode in float32).  The
16-bit SISO and the 16-bit resumable state are held against the reference's
bfloat16 numerics, its Pallas kernel in interpret mode with bfloat16 metrics.  Inputs are made with numpy from a seed and handed to
both packages.  Hard outputs (bits, CRC flags) must be equal exactly; float
outputs to the tolerance stated at each test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.fec.convolutional as j_conv
import srslte_tpu.phy.fec.crc as j_crc
import srslte_tpu.phy.fec.tdec as j_tdec
import srslte_tpu.phy.fec.turbo as j_turbo
import srslte_tpu.phy.phch.dlsch as j_dlsch
import srslte_tpu_torch.phy.fec.convolutional as t_conv
import srslte_tpu_torch.phy.fec.crc as t_crc
import srslte_tpu_torch.phy.fec.tdec as t_tdec
import srslte_tpu_torch.phy.fec.turbo as t_turbo
import srslte_tpu_torch.phy.phch.dlsch as t_dlsch
from srslte_tpu_torch import convert
from srslte_tpu_torch._device import default_device
from srslte_tpu_torch.ops import tdec_cuda, viterbi_cuda
from srslte_tpu_torch.utils import jit

CPU = "cpu"
torch.set_num_threads(1)  # several test workers share the machine's cores


@functools.lru_cache(maxsize=None)
def j_turbo_decode(k, n_iter):
    """The reference's decoder, jitted once per (K, iterations):
    (llr, apr0 or None) -> (hard, posterior, a-priori state)."""
    return jax.jit(lambda llr, apr0=None: j_tdec.turbo_decode(
        llr, k, n_iter=n_iter, apr0=apr0, return_state=True))


def tt(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def turbo_llrs(rng, n, k, snr_db=1.5):
    """Encoded random blocks through BPSK + AWGN: (bits, dcat LLRs float32)."""
    bits = rng.integers(0, 2, (n, k)).astype(np.uint8)
    coded = j_turbo.turbo_encode_np(bits).astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * coded) + sigma * rng.standard_normal(coded.shape)
    return bits, (-y * 2 / sigma**2).astype(np.float32)


def assert_llr_close(got, ref, rel=1e-4):
    """Float LLRs agree to rel * max|ref| (float32 sums taken in another
    order), and hard decisions agree wherever |ref| exceeds that."""
    got, ref = np.asarray(got), np.asarray(ref)
    tol = rel * np.abs(ref).max()
    assert np.abs(got - ref).max() <= tol
    sure = np.abs(ref) > tol
    assert np.array_equal((got > 0)[sure], (ref > 0)[sure])


# ----------------------------------------------------------------- device
def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        assert default_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError):
            default_device()
        with pytest.raises(RuntimeError):  # host data and no device named
            t_turbo.turbo_encode(np.zeros((1, 40), np.uint8), 40)


# ------------------------------------------------------------------- SISO
@pytest.mark.parametrize("k,L,T", [(40, 8, 4), (1024, 128, 32), (2112, 256, 32),
                                   (1056, 256, 32)])
def test_siso_plain_matches_reference_scan(k, L, T):
    """`_siso_windowed` (the kernel's plain version) vs the reference's f32
    scan: the same adds and max in the same order, so equal to the last bit
    (tolerance 0)."""
    rng = np.random.default_rng(k)
    _, llr = turbo_llrs(rng, 3, k)
    d = k + 4
    sys_, par = llr[:, :k], llr[:, d:d + k]
    tx, tz = (rng.standard_normal((3, 3)).astype(np.float32) for _ in range(2))
    ref = np.asarray(j_tdec._siso_windowed(jnp.asarray(sys_), jnp.asarray(par),
                                           jnp.asarray(tx), jnp.asarray(tz), L, T))
    got = t_tdec._siso_windowed(tt(sys_), tt(par), tt(tx), tt(tz), L, T).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        t_tdec._tail_beta(tt(tx), tt(tz)).numpy(),
        np.asarray(j_tdec._tail_beta(jnp.asarray(tx), jnp.asarray(tz))))


@pytest.mark.parametrize("emit_ext,use_perm", [(False, False), (True, False), (True, True)])
def test_siso_wrapper_options(emit_ext, use_perm):
    """emit_ext and perm of `siso_windowed` (CPU tensor -> plain version) are
    the reference scan on permuted input, minus that input: tolerance 0."""
    k, L, T = 512, 128, 32
    rng = np.random.default_rng(5)
    _, llr = turbo_llrs(rng, 2, k)
    sys_, par = llr[:, :k], llr[:, k + 4:2 * k + 4]
    tx, tz = (rng.standard_normal((2, 3)).astype(np.float32) for _ in range(2))
    pi = j_turbo.qpp_perm(k)
    sa = sys_[:, pi] if use_perm else sys_
    ref = np.asarray(j_tdec._siso_windowed(jnp.asarray(sa), jnp.asarray(par),
                                           jnp.asarray(tx), jnp.asarray(tz), L, T))
    if emit_ext:
        ref = ref - sa
    before = tdec_cuda.siso_windowed.launches
    got = tdec_cuda.siso_windowed(
        tt(sys_), tt(par), t_tdec._tail_beta(tt(tx), tt(tz)), L, T, emit_ext=emit_ext,
        perm=tt(pi.astype(np.int32)) if use_perm else None).numpy()
    np.testing.assert_array_equal(got, ref)
    assert tdec_cuda.siso_windowed.launches == before  # no kernel on a CPU tensor


@pytest.mark.parametrize("emit_ext", [False, True])
def test_siso_plain_matches_pallas_interpreter(emit_ext):
    """Against the reference's Pallas kernel itself (f32, interpret mode) at
    the only size its interpreter compiles quickly, (K 40, L 8, T 4), with
    the QPP permutation folded into the gather: tolerance 0."""
    from srslte_tpu.ops.tdec_pallas import (prepare_beta_init, prepare_windows,
                                            siso_from_windows)

    k, B, L, T = 40, 3, 8, 4
    rng = np.random.default_rng(7)
    _, llr = turbo_llrs(rng, B, k)
    sys_, par = llr[:, :k], llr[:, k + 4:2 * k + 4]
    tx, tz = (rng.standard_normal((B, 3)).astype(np.float32) for _ in range(2))
    pi = j_turbo.qpp_perm(k)
    sa_w = prepare_windows(jnp.asarray(sys_), k, L, T, perm=jnp.asarray(pi))
    pr_w = prepare_windows(jnp.asarray(par), k, L, T)
    b0 = prepare_beta_init(jnp.asarray(tx), jnp.asarray(tz), B, k, L, T)
    ref = np.asarray(siso_from_windows(sa_w, pr_w, b0, B, k, L, T, emit_ext=emit_ext))
    got = tdec_cuda.siso_windowed(
        tt(sys_), tt(par), t_tdec._tail_beta(tt(tx), tt(tz)), L, T, emit_ext=emit_ext,
        perm=tt(pi.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref)


def bf16_siso_inputs(rng, B, k):
    """Scaled and clipped decoder inputs as `tdec.turbo_start` makes them on
    the 16-bit path (float32, values exact in bfloat16 after the cast), and
    scaled float32 tails."""
    _, llr = turbo_llrs(rng, B, k)
    sc = np.float32(8.0) / np.abs(llr[:, :k]).mean(dtype=np.float32)
    clip = lambda x: np.clip(x * sc, -32, 32).astype(np.float32)
    tails = [(rng.standard_normal((B, 3)) * 8).astype(np.float32) for _ in range(2)]
    return clip(llr[:, :k]), clip(llr[:, k + 4:2 * k + 4]), tails


@pytest.mark.parametrize("emit_ext,use_perm", [(False, False), (True, True)])
def test_siso_bf16_matches_pallas_interpreter(emit_ext, use_perm):
    """The 16-bit SISO's plain version (what `siso_windowed` runs for a CPU
    tensor, and what the CUDA kernel is held against on the card) against
    the reference's Pallas kernel run with bfloat16 metrics in interpret
    mode, at (K 40, L 8, T 4, B 3) with the cast tail-beta init of the last
    window.  Found: the interpreter (XLA on the CPU) rounds every bfloat16
    operation to bfloat16, as PyTorch does, so the two are equal exactly
    (tolerance 0), posterior and extrinsic, with and without the QPP
    permutation folded into the read."""
    from srslte_tpu.ops.tdec_pallas import (prepare_beta_init, prepare_windows,
                                            siso_from_windows)

    k, B, L, T = 40, 3, 8, 4
    rng = np.random.default_rng(17)
    sys_, par, (tx, tz) = bf16_siso_inputs(rng, B, k)
    pi = j_turbo.qpp_perm(k)
    bf = jnp.bfloat16
    sa_w = prepare_windows(jnp.asarray(sys_), k, L, T,
                           perm=jnp.asarray(pi) if use_perm else None, dtype=bf)
    pr_w = prepare_windows(jnp.asarray(par), k, L, T, dtype=bf)
    b0 = prepare_beta_init(jnp.asarray(tx), jnp.asarray(tz), B, k, L, T, dtype=bf)
    ref = np.asarray(siso_from_windows(sa_w, pr_w, b0, B, k, L, T,
                                       emit_ext=emit_ext).astype(jnp.float32))
    tb = lambda x: tt(x).to(torch.bfloat16)
    before = tdec_cuda.siso_windowed.launches_bf16
    got = tdec_cuda.siso_windowed(
        tb(sys_), tb(par), t_tdec._tail_beta(tt(tx), tt(tz)).to(torch.bfloat16), L, T,
        emit_ext=emit_ext, perm=tt(pi.astype(np.int32)) if use_perm else None)
    assert got.dtype == torch.bfloat16
    assert tdec_cuda.siso_windowed.launches_bf16 == before  # no kernel on a CPU tensor
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_bf16_resumable_state_matches_reference(monkeypatch):
    """The 16-bit resumable state against the reference's (its bfloat16
    numerics selected with SRSLTE_TPU_SISO_DTYPE=bf16, the Pallas kernel in
    interpret mode) at (K 40, L 8, T 4, B 3): turbo_start, turbo_step (2
    iterations, first=True), turbo_take and turbo_hard.  Found: the scale sc
    is a float32 mean over the batch, summed in another order, and differs
    by up to two float32 ulps (rtol 2.5e-7); the rounding to bfloat16
    absorbs that, and every bfloat16 tensor (sys_d, e1, ext2) is equal
    exactly (tolerance 0); the posterior, divided by sc in float32, agrees
    to rtol 1e-6, and the hard bits are equal.  Then one JAX state, after 1
    iteration, is carried across with `convert.turbo_state_from_numpy` (its
    own sc) and one more iteration in the port equals the reference's second
    exactly."""
    monkeypatch.setenv("SRSLTE_TPU_SISO_DTYPE", "bf16")
    k, B, L, T = 40, 3, 8, 4
    rng = np.random.default_rng(23)
    _, llr = turbo_llrs(rng, B, k, snr_db=0.5)
    bf = torch.bfloat16
    as_np = lambda x: np.asarray(jnp.asarray(x).astype(jnp.float32))

    sj = j_tdec.turbo_start(jnp.asarray(llr), k, L=L, T=T)
    assert sj.sys_d.dtype == jnp.bfloat16
    st = t_tdec.turbo_start(llr, k, L=L, T=T, device=CPU, siso_dtype=bf)
    np.testing.assert_allclose(st.sc.numpy(), as_np(sj.sc), rtol=2.5e-7)
    np.testing.assert_array_equal(st.sys_d.float().numpy(), as_np(sj.sys_d))
    assert st.sys_sat.dtype == st.par1.dtype == st.b01.dtype == bf

    sj1 = j_tdec.turbo_step(sj, k, 1, L=L, T=T, first=True)
    sj2 = j_tdec.turbo_step(sj1, k, 1, L=L, T=T)
    st2 = t_tdec.turbo_step(st, k, 2, L=L, T=T, first=True)
    for f in ("e1", "ext2"):
        assert getattr(st2, f).dtype == bf
        np.testing.assert_array_equal(getattr(st2, f).float().numpy(), as_np(getattr(sj2, f)))
    hj, pj, aj = j_tdec.turbo_hard(sj2, k)
    ht, pt, at = t_tdec.turbo_hard(st2, k)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-6)
    np.testing.assert_allclose(at.numpy(), np.asarray(aj), rtol=1e-6)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))

    idx = np.array([2, 0])
    tj = j_tdec.turbo_take(sj2, jnp.asarray(idx), k, L=L, T=T)
    tk = t_tdec.turbo_take(st2, torch.as_tensor(idx), k)
    np.testing.assert_array_equal(tk.e1.float().numpy(), as_np(tj.e1))
    np.testing.assert_array_equal(tk.sys_d.float().numpy(), as_np(tj.sys_d))
    np.testing.assert_allclose(tk.sc.numpy(), as_np(tj.sc), rtol=2.5e-7)

    sys_, par1, par2, t1, t2 = j_tdec._split_dcat(jnp.asarray(llr), k)
    carried = convert.turbo_state_from_numpy(
        as_np(sys_), as_np(par1), as_np(par2),
        (tuple(map(as_np, t1)), tuple(map(as_np, t2))),
        as_np(sj1.e1), as_np(sj1.ext2), as_np(sj1.sc), sys_d=as_np(sj1.sys_d),
        siso_dtype=bf, device=CPU)
    np.testing.assert_array_equal(carried.sc.numpy(), as_np(sj.sc))
    for f in ("sys_sat", "sys_d", "par1", "par2", "b01", "b02"):
        np.testing.assert_array_equal(getattr(carried, f).float().numpy(),
                                      getattr(st, f).float().numpy())
    c2 = t_tdec.turbo_step(carried, k, 1, L=L, T=T)
    np.testing.assert_array_equal(c2.ext2.float().numpy(), as_np(sj2.ext2))
    np.testing.assert_array_equal(t_tdec.turbo_hard(c2, k)[1].numpy(), np.asarray(pj))


@pytest.mark.parametrize("k,snr_db", [(512, 8.0), (512, 1.5), (1056, 1.0)])
def test_bf16_decoder_against_float32(k, snr_db):
    """The 16-bit decoder at a windowed K on the CPU (the plain version with
    bfloat16 metrics) against the port's own float32 decoder: the reference
    has no CPU path that reaches its bfloat16 numerics at T 32, so this is
    the port against itself.  `turbo_decode` and `dlsch_decode` (cascade,
    one code block per TB): hard bits and CRC flags equal, on clean and on
    moderately noisy inputs."""
    rng = np.random.default_rng(k + int(snr_db))
    bits, llr = turbo_llrs(rng, 4, k, snr_db=snr_db)
    h32, _ = t_tdec.turbo_decode(llr, k, n_iter=4, device=CPU)
    h16, p16 = t_tdec.turbo_decode(llr, k, n_iter=4, device=CPU, siso_dtype=torch.bfloat16)
    np.testing.assert_array_equal(h16.numpy(), h32.numpy())
    np.testing.assert_array_equal(h16.numpy(), bits)
    assert p16.dtype == torch.float32

    tbs = k - 24
    cfg = t_dlsch.DlschConfig(tbs=tbs, G=3 * k, Qm=2)
    tb = rng.integers(0, 2, (6, tbs)).astype(np.uint8)
    coded = t_dlsch.dlsch_encode(tb, cfg, device=CPU).numpy().astype(np.float32)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * coded) + sigma * rng.standard_normal(coded.shape)
    dl = (-y * 2 / sigma**2).astype(np.float32)
    b32, ok32 = t_dlsch.dlsch_decode(dl, cfg, device=CPU)
    b16, ok16 = t_dlsch.dlsch_decode(dl, cfg, device=CPU, siso_dtype=torch.bfloat16)
    np.testing.assert_array_equal(ok16.numpy(), ok32.numpy())
    assert ok16.all()
    np.testing.assert_array_equal(b16.numpy(), b32.numpy())


def test_siso_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros((2, 64))
    b0 = torch.zeros((2, 8))
    with pytest.raises(TypeError):
        tdec_cuda.siso_windowed(x.double(), x.double(), b0.double(), 8, 4)
    with pytest.raises(ValueError):
        tdec_cuda.siso_windowed(x, x[:, :32], b0, 8, 4)
    with pytest.raises(ValueError):
        tdec_cuda.siso_windowed(x.T.contiguous().T, x, b0, 8, 4)  # not contiguous
    with pytest.raises(TypeError):
        tdec_cuda.siso_windowed(x, x, b0, 8, 4, perm=torch.arange(64))  # int64
    with pytest.raises(TypeError):  # mixed float32 and bfloat16
        tdec_cuda.siso_windowed(x.bfloat16(), x, b0, 8, 4)
    with pytest.raises(TypeError):
        tdec_cuda.siso_windowed(x.bfloat16(), x.bfloat16(), b0, 8, 4)
    # a window whose history does not fit in a block's shared memory: the
    # launch plan, which the wrapper makes for a CUDA tensor, refuses it
    with pytest.raises(ValueError):
        tdec_cuda.siso_plan(2, 40, 2048, 4, False)
    with pytest.raises(ValueError):
        tdec_cuda.siso_plan(2, 40, 2048, 4, True)
    with pytest.raises(ValueError):
        t_tdec.turbo_start(np.zeros((2, 3 * 260), np.float32), 256, device=CPU,
                           siso_dtype=torch.float16)
    with pytest.raises(ValueError):
        viterbi_cuda.viterbi_decode(torch.zeros((2, 100)), 44)
    with pytest.raises(TypeError):
        viterbi_cuda.viterbi_decode(torch.zeros((2, 132), dtype=torch.float64), 44)


# ----------------------------------------------------------- turbo decode
@pytest.mark.parametrize("k", [40, 104])
def test_short_block_decode(k):
    """K < 256: full-length scans (`_siso`) in both packages; same ops on the
    same inputs, so LLRs to 1e-5 of their scale and bits exactly."""
    rng = np.random.default_rng(k)
    bits, llr = turbo_llrs(rng, 4, k, snr_db=2.0)
    hj, pj, _ = j_turbo_decode(k, 3)(jnp.asarray(llr))
    ht, pt = t_tdec.turbo_decode(llr, k, n_iter=3, device=CPU)
    assert_llr_close(pt.numpy(), pj, rel=1e-5)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    assert ht.dtype == torch.uint8


@pytest.mark.parametrize("k", [512, 2112])
def test_windowed_decode_and_warm_start(k):
    """K >= 256: the port threads extrinsics (llr - (sys + apr)), the
    reference's f32 path forms (llr - sys) - apr: the same values up to
    float32 rounding, hence rel 1e-4 on the posterior; bits exact.  Then the
    state carried across: 1 iteration in JAX, its a-priori through
    `convert.apr_from_numpy`, 2 more in the port == 3 iterations in JAX."""
    rng = np.random.default_rng(k)
    bits, llr = turbo_llrs(rng, 3, k, snr_db=1.5)
    hj, pj, apr3 = j_turbo_decode(k, 3)(jnp.asarray(llr))
    ht, pt = t_tdec.turbo_decode(llr, k, n_iter=3, device=CPU)
    assert_llr_close(pt.numpy(), pj)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    np.testing.assert_array_equal(ht.numpy(), bits)

    _, _, apr = j_turbo_decode(k, 1)(jnp.asarray(llr))
    apr0 = convert.apr_from_numpy(np.asarray(apr), device=CPU)
    h2, p2, apr2 = t_tdec.turbo_decode(llr, k, n_iter=2, apr0=apr0, return_state=True,
                                       device=CPU)
    assert_llr_close(p2.numpy(), pj)
    np.testing.assert_array_equal(h2.numpy(), np.asarray(hj))
    assert_llr_close(apr2.numpy(), apr3)


def test_resumable_state_carried_across():
    """The state-threading path: the JAX package prepares a TurboState and
    runs 1 iteration through its Pallas kernel (f32, interpret mode, at the
    size the interpreter compiles quickly), the state goes through
    `convert.turbo_state_from_numpy`, the port runs 2 more; the result is
    held against 3 iterations in JAX.  Same arithmetic: tolerance 1e-5."""
    k, B, L, T = 40, 3, 8, 4
    rng = np.random.default_rng(11)
    _, llr = turbo_llrs(rng, B, k)
    st = j_tdec.turbo_start(jnp.asarray(llr), k, L=L, T=T)
    assert st.sys_d.dtype == jnp.float32  # the reference's f32 numerics
    st1 = j_tdec.turbo_step(st, k, 1, L=L, T=T, first=True)
    st3 = j_tdec.turbo_step(st1, k, 2, L=L, T=T)
    hj, pj, aj = j_tdec.turbo_hard(st3, k)

    sys_, par1, par2, t1, t2 = j_tdec._split_dcat(jnp.asarray(llr), k)
    as_np = lambda x: np.asarray(x, np.float32)
    ts = convert.turbo_state_from_numpy(
        as_np(sys_), as_np(par1), as_np(par2),
        (tuple(map(as_np, t1)), tuple(map(as_np, t2))),
        as_np(st1.e1), as_np(st1.ext2), as_np(st1.sc), device=CPU)
    ts = t_tdec.turbo_step(ts, k, 2, L=L, T=T)
    ht, pt, at = t_tdec.turbo_hard(ts, k)
    assert_llr_close(pt.numpy(), pj, rel=1e-5)
    assert_llr_close(at.numpy(), aj, rel=1e-5)
    np.testing.assert_array_equal(ht.numpy(), np.asarray(hj))
    # and a fresh state in the port equals the carried one
    fresh = t_tdec.turbo_step(t_tdec.turbo_start(llr, k, L=L, T=T, device=CPU), k, 3,
                              L=L, T=T, first=True)
    assert_llr_close(t_tdec.turbo_hard(fresh, k)[1].numpy(), pj, rel=1e-5)
    sub = t_tdec.turbo_take(fresh, torch.tensor([2, 0]), k)
    np.testing.assert_array_equal(sub.e1.numpy(), fresh.e1.numpy()[[2, 0]])


def test_default_window_and_state_supported():
    for k in (40, 248, 256, 2040, 2048, 6144):
        assert j_tdec.default_window(k) == t_tdec.default_window(k)
        assert t_tdec.state_supported(k) == (k >= 256)


# ------------------------------------------------- encoder / rate matching
@pytest.mark.parametrize("k,e,f", [(40, 132, 0), (512, 700, 8), (1024, 4000, 0)])
def test_turbo_encode_and_rate_matching(k, e, f):
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (2, 3, k)).astype(np.uint8)
    dj = np.asarray(j_turbo.turbo_encode(jnp.asarray(bits), k))
    dt = t_turbo.turbo_encode(bits, k, device=CPU)
    np.testing.assert_array_equal(dt.numpy(), dj)
    np.testing.assert_array_equal(
        t_turbo.rm_tx(dt, k, e, 0, f).numpy(),
        np.asarray(j_turbo.rm_tx(jnp.asarray(dj), k, e, 0, f)))
    llr = rng.standard_normal((2, 3, e)).astype(np.float32)
    # soft combining sums at most a few repeats of one position: rel 1e-6
    np.testing.assert_allclose(
        t_turbo.rm_rx(llr, k, 0, f, device=CPU).numpy(),
        np.asarray(j_turbo.rm_rx(jnp.asarray(llr), k, 0, f)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [40, 1024, 6144])
def test_turbo_encode_matches_reference(k):
    """The closed-form encoder equals the reference's generator-matrix
    product bit for bit (tails included)."""
    bits = np.random.default_rng(k + 1).integers(0, 2, (3, k)).astype(np.uint8)
    np.testing.assert_array_equal(t_turbo.turbo_encode(bits, k, device=CPU).numpy(),
                                  np.asarray(j_turbo.turbo_encode(jnp.asarray(bits), k)))


def test_turbo_encode_every_block_size():
    """Equal to the reference's host encoder at all 188 code-block sizes of
    36.212 table 5.1.3-3."""
    rng = np.random.default_rng(188)
    for k in j_turbo.cb_sizes():
        bits = rng.integers(0, 2, (2, k)).astype(np.uint8)
        np.testing.assert_array_equal(t_turbo.turbo_encode(bits, k, device=CPU).numpy(),
                                      j_turbo.turbo_encode_np(bits), err_msg=f"K={k}")


def test_turbo_encode_keeps_no_generator_matrix():
    """Encoding keeps no per-K matrix among the device tables: only the
    QPP permutation, K int64 values per size."""
    from srslte_tpu_torch import _device

    for k in (40, 512, 1024, 5824, 6144):
        t_turbo.turbo_encode(np.zeros((1, k), np.uint8), k, device=CPU)
        assert _device._TABLES[(("qpp", k), "cpu", None)].numel() == k
    assert not [key for key in _device._TABLES if key[0][0] == "turbo_g"]


def test_crc_ok_device():
    rng = np.random.default_rng(3)
    poly, order = t_crc.LTE_CRC16
    msg = rng.integers(0, 2, (5, 7, 28)).astype(np.uint8)
    mask = rng.integers(0, 2, 16).astype(np.uint8)
    cw = np.concatenate([msg, t_crc.crc_bits(msg, poly, order) ^ mask], -1)
    cw[0, 0, 3] ^= 1
    cw[4, 6, 40] ^= 1
    ref = np.asarray(j_crc.crc_ok_device(jnp.asarray(cw), poly, order, rnti_mask=jnp.asarray(mask)))
    got = t_crc.crc_ok_device(cw, poly, order, rnti_mask=mask, device=CPU).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.sum() == 33
    pa, oa = t_crc.LTE_CRC24A
    big = t_crc.crc_attach(rng.integers(0, 2, (2, 6000)).astype(np.uint8), pa, oa)
    assert t_crc.crc_ok_device(big, pa, oa, device=CPU).all()


@pytest.mark.parametrize("length", [1, 16, 35, 100])
def test_crc12(length):
    """`LTE_CRC12` through `crc_bits` and `crc_ok_device`, bit-exact with
    the reference's."""
    assert t_crc.LTE_CRC12 == j_crc.LTE_CRC12
    rng = np.random.default_rng(length)
    msg = rng.integers(0, 2, (4, length)).astype(np.uint8)
    got = t_crc.crc_bits(msg, *t_crc.LTE_CRC12)
    np.testing.assert_array_equal(got, j_crc.crc_bits(msg, *j_crc.LTE_CRC12))
    cw = np.concatenate([msg, got], -1)
    cw[1, 0] ^= 1
    ok = t_crc.crc_ok_device(cw, *t_crc.LTE_CRC12, device=CPU).numpy()
    np.testing.assert_array_equal(ok, [True, False, True, True])


# ------------------------------------------------------------ convolutional
def test_conv_encode_and_rate_matching():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, (6, 44)).astype(np.uint8)
    cj = np.asarray(j_conv.conv_encode(jnp.asarray(bits), 44))
    ct = t_conv.conv_encode(bits, 44, device=CPU)
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(ct.numpy(), t_conv.conv_encode_np(bits))
    for e in (72, 144, 288, 576):
        np.testing.assert_array_equal(t_conv.rm_conv_tx(ct, e).numpy(),
                                      np.asarray(j_conv.rm_conv_tx(jnp.asarray(cj), e)))
        llr = rng.standard_normal((6, e)).astype(np.float32)
        np.testing.assert_allclose(
            t_conv.rm_conv_rx(llr, 132, device=CPU).numpy(),
            np.asarray(j_conv.rm_conv_rx(jnp.asarray(llr), 132)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("noise", [0.0, 0.8, "erased tail"])
@pytest.mark.parametrize("tail_biting", [True, False])
@pytest.mark.parametrize("length", [44, 27])
def test_viterbi_matches_reference_scan(length, tail_biting, noise):
    """The port's radix-2 Viterbi (the kernel's tie rules, no normalisation)
    against the reference's radix-4 scan (normalised, argmax over four): the
    decoded bits must be equal exactly, on noisy float LLRs and on clean ones
    (where ties occur only between losing paths).  With the last 8 steps
    erased (LLR 0) every end state ties and so does every decision of those
    steps: the first maximum and predecessor A must win in both."""
    rng = np.random.default_rng(length)
    bits = rng.integers(0, 2, (24, length)).astype(np.uint8)
    coded = j_conv.conv_encode_np(bits).astype(np.float32)
    erased, noise = (True, 0.0) if noise == "erased tail" else (False, noise)
    llr = (-(1.0 - 2.0 * coded) + noise * rng.standard_normal(coded.shape)).astype(np.float32)
    if erased:
        llr[:, -24:] = 0.0
    ref = np.asarray(j_conv.viterbi_decode(jnp.asarray(llr), length, tail_biting=tail_biting,
                                           backend="xla"))
    got = t_conv.viterbi_decode(llr, length, tail_biting=tail_biting, device=CPU)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref)
    if tail_biting and noise == 0.0 and not erased:
        np.testing.assert_array_equal(got.numpy(), bits)


@pytest.mark.parametrize("length,tail_biting", [(4, True), (8, False)])
def test_viterbi_matches_pallas_interpreter(length, tail_biting):
    """Against the reference's Pallas Viterbi kernel in interpret mode, at
    the step counts its interpreter compiles in well under a minute (12 and
    8 trellis steps): random float LLRs, bits equal exactly.  Not tail-biting
    pins state 0, as the kernel's code does."""
    rng = np.random.default_rng(length)
    llr = rng.standard_normal((5, 3 * length)).astype(np.float32)
    ref = np.asarray(j_conv.viterbi_decode(jnp.asarray(llr), length, tail_biting=tail_biting,
                                           backend="pallas"))
    got = t_conv.viterbi_decode(llr, length, tail_biting=tail_biting, device=CPU).numpy()
    np.testing.assert_array_equal(got, ref)


# ------------------------------------------------------------------ DL-SCH
CASCADE_CFG = dict(tbs=488, G=1056, Qm=2)  # one code block of K 512 per TB
CASCADE_N = 64  # TBs per batch: capacity 8, second capacity 2


@functools.lru_cache(maxsize=None)
def j_dlsch_decode(n_iter=5):
    cfg = j_dlsch.DlschConfig(**CASCADE_CFG)
    return jax.jit(lambda llr: j_dlsch.dlsch_decode(llr, cfg, n_iter=n_iter))


@functools.lru_cache(maxsize=1)
def cascade_pool():
    """A pool of noisy TBs over a range of SNRs, with the number of turbo
    iterations each needs before its CRC passes (99: never within 5),
    measured with the port's own decoder one iteration at a time."""
    cfg = t_dlsch.DlschConfig(**CASCADE_CFG)
    rng = np.random.default_rng(0)
    P = 320
    bits = rng.integers(0, 2, (P, cfg.tbs)).astype(np.uint8)
    coded = t_dlsch.dlsch_encode(bits, cfg, device=CPU).numpy().astype(np.float32)
    sigma = 10 ** (-np.linspace(-0.5, 5.0, P)[:, None] / 20)
    y = (1 - 2 * coded) + sigma * rng.standard_normal(coded.shape)
    llr = (-y * 2 / sigma**2).astype(np.float32)
    (K, f0, w), = t_dlsch._derm_clusters(tt(llr), cfg)
    st = t_tdec.turbo_start(w.reshape(P, -1), K)
    need = np.full(P, 99)
    for it in range(1, 6):
        st = t_tdec.turbo_step(st, K, 1, first=(it == 1))
        ok = t_crc.crc_ok_device(t_tdec.turbo_hard(st, K)[0], *t_crc.LTE_CRC24A).numpy()
        need[(need == 99) & ok] = it
    return bits, llr, need


# branch name -> (how many TBs of each iterations-needed class, the expected
# trace of (batch, iterations) turbo_step calls for n_iter 5)
N_, CAP, CAP2 = CASCADE_N, 8, 2
CASCADE_CASES = {
    "all_pass_after_early": ({1: N_}, [(N_, 1)]),
    "all_pass_after_second": ({1: N_ - 5, 2: 5}, [(N_, 1), (N_, 1)]),
    "compaction_then_clean": ({1: N_ - 8, 2: 5, 3: 3}, [(N_, 1), (N_, 1), (CAP, 1)]),
    "second_compaction": ({1: N_ - 8, 2: 3, 3: 3, 4: 1, 99: 1},
                          [(N_, 1), (N_, 1), (CAP, 1), (CAP2, 2)]),
    "second_capacity_exceeded": ({1: N_ - 8, 2: 2, 3: 2, 4: 2, 5: 1, 99: 1},
                                 [(N_, 1), (N_, 1), (CAP, 1), (CAP, 2)]),
    "full_batch_fallback": ({1: N_ - 14, 2: 3, 3: 5, 4: 3, 5: 2, 99: 1},
                            [(N_, 1), (N_, 1), (N_, 3)]),
}


def cascade_rows(branch, need):
    """The pool rows of one mix of CASCADE_CASES, drawn by its name."""
    rng = np.random.default_rng(len(branch))
    rows = np.concatenate([rng.choice(np.flatnonzero(need == n), c, replace=False)
                           for n, c in CASCADE_CASES[branch][0].items()])
    return rng.permutation(rows)


@pytest.mark.parametrize("branch", list(CASCADE_CASES))
def test_dlsch_decode_cascade(branch, monkeypatch):
    """Every branch of the CRC-gated cascade (`jit.cond` on counts in the
    port, eagerly one branch, `lax.cond` on traced counts in the reference):
    the same CRC flags, and the same bits wherever the CRC passes.  The
    branch taken is read off the (batch, iterations) trace of the port's
    turbo_step calls."""
    mix, want_trace = CASCADE_CASES[branch]
    bits, llr, need = cascade_pool()
    rows = cascade_rows(branch, need)
    assert len(rows) == CASCADE_N

    trace = []
    real_step = t_tdec.turbo_step

    def logged_step(st, k, n_iter, *a, **kw):
        trace.append((st.sys.shape[0], n_iter))
        return real_step(st, k, n_iter, *a, **kw)

    monkeypatch.setattr(t_dlsch.tdec, "turbo_step", logged_step)
    cfg = t_dlsch.DlschConfig(**CASCADE_CFG)
    got_bits, got_ok = t_dlsch.dlsch_decode(llr[rows], cfg, n_iter=5, device=CPU)
    assert trace == want_trace

    ref_bits, ref_ok = j_dlsch_decode()(jnp.asarray(llr[rows]))
    ref_bits, ref_ok = np.asarray(ref_bits), np.asarray(ref_ok)
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)
    np.testing.assert_array_equal(got_ok.numpy(), need[rows] <= 5)
    np.testing.assert_array_equal(got_bits.numpy()[ref_ok], ref_bits[ref_ok])
    np.testing.assert_array_equal(got_bits.numpy()[ref_ok], bits[rows][ref_ok])
    assert got_bits.dtype == torch.uint8 and got_ok.dtype == torch.bool


@pytest.mark.parametrize("branch", list(CASCADE_CASES))
def test_dlsch_decode_cascade_traced(branch, monkeypatch):
    """The cascade as its CUDA graph runs it: every `jit.cond` under
    `jit.tracing` (both branches, merged by the predicate).  CRC flags and
    bits equal the eager port's and the reference's jitted `dlsch_decode`'s
    (bits wherever the CRC passes); every branch ran."""
    bits, llr, need = cascade_pool()
    x = llr[cascade_rows(branch, need)]
    cfg = t_dlsch.DlschConfig(**CASCADE_CFG)
    trace = []
    real_step = t_tdec.turbo_step

    def logged_step(st, k, n_iter, *a, **kw):
        trace.append((st.sys.shape[0], n_iter))
        return real_step(st, k, n_iter, *a, **kw)

    monkeypatch.setattr(t_dlsch.tdec, "turbo_step", logged_step)
    with jit.tracing():
        got_bits, got_ok = t_dlsch.dlsch_decode(x, cfg, n_iter=5, device=CPU)
    assert sorted(trace) == sorted([(N_, 1), (N_, 1), (CAP, 1), (CAP2, 2), (CAP, 2), (N_, 3)])
    monkeypatch.undo()
    eager_bits, eager_ok = t_dlsch.dlsch_decode(x, cfg, n_iter=5, device=CPU)
    np.testing.assert_array_equal(got_ok.numpy(), eager_ok.numpy())
    np.testing.assert_array_equal(got_bits.numpy(), eager_bits.numpy())
    ref_bits, ref_ok = (np.asarray(a) for a in j_dlsch_decode()(jnp.asarray(x)))
    np.testing.assert_array_equal(got_ok.numpy(), ref_ok)
    np.testing.assert_array_equal(got_bits.numpy()[ref_ok], ref_bits[ref_ok])


@pytest.mark.parametrize("tbs,G,Qm,snr_db", [(6200, 14400, 4, 1.0), (208, 480, 2, 3.0)])
def test_dlsch_encode_decode_multi_cb_and_short(tbs, G, Qm, snr_db):
    """A TB of two code blocks with filler bits (one gather per K, CB CRCs),
    and a TB below the windowed size (the a-priori-threading adapter):
    encoders equal exactly; decoders, cascade and fixed-iteration, give the
    same flags and the same bits where the CRC passes."""
    jcfg, tcfg = j_dlsch.DlschConfig(tbs, G, Qm), t_dlsch.DlschConfig(tbs, G, Qm)
    rng = np.random.default_rng(tbs)
    bits = rng.integers(0, 2, (2, 3, tbs)).astype(np.uint8)
    cj = np.asarray(jax.jit(lambda b: j_dlsch.dlsch_encode(b, jcfg))(jnp.asarray(bits)))
    ct = t_dlsch.dlsch_encode(bits, tcfg, device=CPU).numpy()
    np.testing.assert_array_equal(ct, cj)
    sigma = 10 ** (-snr_db / 20)
    y = (1 - 2 * ct.astype(np.float32)) + sigma * rng.standard_normal(ct.shape)
    llr = (-y * 2 / sigma**2).astype(np.float32)
    llr[1, 2] *= 0.05 * rng.standard_normal(G)  # one TB beyond repair
    for kw in (dict(n_iter=4), dict(n_iter=3, early=0)):
        bj, okj = jax.jit(lambda x: j_dlsch.dlsch_decode(x, jcfg, **kw))(jnp.asarray(llr))
        bt, okt = t_dlsch.dlsch_decode(llr, tcfg, device=CPU, **kw)
        okj = np.asarray(okj)
        np.testing.assert_array_equal(okt.numpy(), okj)
        assert okj.sum() == 5 and not okj[1, 2]
        np.testing.assert_array_equal(bt.numpy()[okj], np.asarray(bj)[okj])
        np.testing.assert_array_equal(bt.numpy()[okj], bits[okj])
    # a retransmission at rv 1 (6 dB stronger: alone, it lacks most of the
    # systematic bits) decodes through the same path in both packages
    jcfg1, tcfg1 = (dataclasses.replace(c, rv=1) for c in (jcfg, tcfg))
    c1 = t_dlsch.dlsch_encode(bits, tcfg1, device=CPU).numpy()
    np.testing.assert_array_equal(
        c1, np.asarray(jax.jit(lambda b: j_dlsch.dlsch_encode(b, jcfg1))(jnp.asarray(bits))))
    s1 = sigma / 2
    llr1 = (-((1 - 2 * c1.astype(np.float32)) + s1 * rng.standard_normal(c1.shape))
            * 2 / s1**2).astype(np.float32)
    bj, okj = jax.jit(lambda x: j_dlsch.dlsch_decode(x, jcfg1, n_iter=4))(jnp.asarray(llr1))
    bt, okt = t_dlsch.dlsch_decode(llr1, tcfg1, n_iter=4, device=CPU)
    okj = np.asarray(okj)
    np.testing.assert_array_equal(okt.numpy(), okj)
    assert okj.any()
    np.testing.assert_array_equal(bt.numpy()[okj], bits[okj])
