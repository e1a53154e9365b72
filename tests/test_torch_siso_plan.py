"""The SISO kernel's launch plan (`ops.tdec_cuda.siso_plan`), on the CPU.

The kernel itself runs only on the card (`chip_smoke.py` holds it against
its plain version there, and its launch refuses a plan whose blocks do not
cover every window with as few blocks as they can, or whose shared bytes are
not exactly what its layout uses).  Its geometry is computed in Python and
checked here: the blocks that the launch accepts, the 16-bit pairing with its
dummy half, the shared memory within what a block may use, for every LTE code
block size at the window the decoder gives it and for the shapes the tests and
`chip_smoke.py` run.
"""

import numpy as np
import pytest
import torch

from srslte_tpu_torch.ops import tdec_cuda
from srslte_tpu_torch.phy.fec.cbsegm import cb_sizes
from srslte_tpu_torch.phy.fec import tdec, turbo
from srslte_tpu_torch.phy.fec.tdec import default_window

torch.set_num_threads(1)  # several test workers share the machine's cores

BATCHES = (1, 3, 128 * 11, 128 * 12)  # one block, a few, a DL and a UL dispatch
GROUPS = tdec_cuda.GROUPS_PER_BLOCK


def assert_plan_covers(B, K, L, T, bf16):
    plan = tdec_cuda.siso_plan(B, K, L, T, bf16)
    N = B * -(-K // L)
    wpg = 2 if bf16 else 1
    assert plan.windows == N and plan.windows_per_group == wpg
    assert plan.threads == GROUPS * tdec_cuda.LANES_PER_GROUP == 32
    # group g of block x holds the windows (x * GROUPS + g) * wpg + h, h < wpg:
    # every window in one slot, and no block without a window (what the
    # kernel's launch checks)
    assert plan.groups == -(-N // wpg)
    assert (plan.blocks - 1) * GROUPS * wpg < N <= plan.blocks * GROUPS * wpg
    # the dummy halves: only in 16 bits, one for an odd count
    assert plan.groups * wpg - N == (N % 2 if bf16 else 0)
    # per group: history L x 8 words, systematic buffer L words, input ring 64
    # words; 4 bytes a word
    assert plan.smem_bytes == GROUPS * (9 * L + 64) * 4
    assert plan.smem_bytes <= tdec_cuda.SMEM_PER_BLOCK == 232448
    return plan


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
def test_plan_every_lte_block_size(bf16):
    """All 188 K at the window the decoder gives them (`turbo_step`:
    default_window(K) or 128), T 32, at a few batch sizes."""
    for k in cb_sizes():
        L = default_window(k) or 128
        for B in BATCHES:
            assert_plan_covers(B, k, L, 32, bf16)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bfloat16"])
@pytest.mark.parametrize("B,K,L,T", [
    (3, 40, 8, 4),  # the Pallas interpreter's shape
    (2, 512, 128, 32),
    (64, 1024, 128, 32),
    (77, 1008, 128, 32),  # ragged: K not a multiple of L, B not of 32
    (3, 256, 256, 32),  # K = L: a single window, window 0 also the last
    (7, 1152, 128, 32),  # B x W = 63, odd
    (128 * 11, 5824, 256, 32),  # the DL path's first launch
    (128 * 12, 5952, 256, 32),  # the UL path's first launch
])
def test_plan_test_shapes(B, K, L, T, bf16):
    assert_plan_covers(B, K, L, T, bf16)


def test_plan_numbers_at_the_paths_shapes():
    """The geometry `chip_smoke.py` launches at the DL's and UL's shapes."""
    dl32 = tdec_cuda.siso_plan(1408, 5824, 256, 32, False)
    assert (dl32.windows, dl32.groups, dl32.blocks, dl32.smem_bytes) == (32384, 32384, 8096, 37888)
    ul16 = tdec_cuda.siso_plan(1536, 5952, 256, 32, True)
    assert (ul16.windows, ul16.groups, ul16.blocks, ul16.smem_bytes) == (36864, 18432, 4608, 37888)


def test_bf16_pairs_span_code_blocks():
    """A 16-bit pair may hold windows of two code blocks (here K = L, so
    window n is code block n's only window, window 0 and the last at once):
    3 windows make 2 pairs in one block, the second with a dummy high half."""
    plan = tdec_cuda.siso_plan(3, 256, 256, 32, True)
    assert (plan.windows, plan.groups, plan.blocks) == (3, 2, 1)
    assert plan.groups * plan.windows_per_group - plan.windows == 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_shape_that_does_not_fit_is_refused(dtype):
    """A window whose history, systematic buffer and gamma ring exceed a
    block's shared memory is refused by the launch plan (which the wrapper
    makes for a CUDA tensor, before any launch); a CPU tensor goes to the
    plain version, which takes any window."""
    with pytest.raises(ValueError):
        tdec_cuda.siso_plan(2, 4096, 2048, 32, dtype == torch.bfloat16)
    # the largest L that fits: 16 * (9 L + 64) bytes <= 232448
    assert_plan_covers(2, 4096, 1607, 32, dtype == torch.bfloat16)
    with pytest.raises(ValueError):
        tdec_cuda.siso_plan(2, 4096, 1608, 32, dtype == torch.bfloat16)
    x = torch.linspace(-4, 4, 1700, dtype=dtype)[None]
    got = tdec_cuda.siso_windowed(x, x.flip(1).contiguous(), torch.zeros((1, 8), dtype=dtype),
                                  1700, 0)
    assert got.shape == (1, 1700) and bool(torch.isfinite(got.float()).all())


# ------------------------------------------------ short code blocks (K < 256)
SHORT_K = tuple(k for k in cb_sizes() if k < 256)


def test_plan_one_window_every_short_block():
    """A code block of K < 256 goes to the kernel on the card as ONE window
    of L = K with no training halo (`tdec._siso_full`): the plan takes it for
    every such K of the LTE table, float32 (the full-length pass is float32
    whatever the decoder's SISO numerics), one window per code block."""
    assert len(SHORT_K) == 27 and SHORT_K[0] == 40 and SHORT_K[-1] == 248
    for k in SHORT_K:
        for B in BATCHES:
            plan = assert_plan_covers(B, k, k, 0, False)
            assert plan.windows == B


@pytest.mark.parametrize("k,snr_db", [(40, 0.0), (112, 8.0), (248, 0.0)])
def test_one_window_pass_equals_full_scan(k, snr_db):
    """The kernel's plain version as one window (L = K, T = 0: alpha from
    state 0, beta from the tail, float32 without renormalisation) against
    the full-length scan `_siso` that the CPU runs (renormalised every
    step): the LLRs of a first-decoder pass to 1e-4 of their scale, the
    signs equal.  On the card the kernel equals its plain version by value
    (`chip_smoke.py` phase 3)."""
    rng = np.random.default_rng(k)
    bits = rng.integers(0, 2, (8, k)).astype(np.uint8)
    coded = turbo.turbo_encode(torch.as_tensor(bits), k).to(torch.float32)
    sigma = 10 ** (-snr_db / 20)
    noise = torch.as_tensor(rng.standard_normal(coded.shape, dtype=np.float32))
    llr = -((1 - 2 * coded) + sigma * noise) * (2 / sigma**2)
    sys_, par1, _, (tx, tz), _ = tdec._split_dcat(llr, k)
    ref = tdec._siso(sys_, par1, tx, tz)
    got = tdec_cuda.siso_windowed_plain(sys_.contiguous(), par1.contiguous(),
                                        tdec._tail_beta(tx, tz), k, 0)
    scale = float(ref.abs().max())
    assert float((got - ref).abs().max()) <= 1e-4 * scale
    np.testing.assert_array_equal((got > 0).numpy(), (ref > 0).numpy())
    # the CPU keeps the scan
    np.testing.assert_array_equal(tdec._siso_full(sys_, par1, tx, tz).numpy(), ref.numpy())
