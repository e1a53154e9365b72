"""The Viterbi kernel's launch plan (`ops.viterbi_cuda.viterbi_plan`), on the CPU.

The kernel itself runs only on the card (`chip_smoke.py` holds it against its
plain version there, bit for bit, and its launch refuses a plan whose blocks
do not cover every candidate with as few blocks as they can, or whose shared
bytes are not exactly what its layout uses).  Its geometry is computed in
Python and checked here for every code length that a caller of the Viterbi
decoder in the JAX package gives it, at the batch sizes of one candidate, a
ragged batch, the UL path's and the DL path's; with the refusal above the
kernel's capacity, the CPU path beyond it, and the plain version against the
reference's scan at the longest caller length.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import srslte_tpu.phy.fec.convolutional as j_conv
import srslte_tpu_torch.phy.fec.convolutional as t_conv
from srslte_tpu_torch.ops import viterbi_cuda

BATCHES = (1, 77, 128, 128 * 18)  # one candidate, ragged, a UL and a DL dispatch
# Code lengths (payload + CRC) of the JAX package's Viterbi callers: PDCCH
# DCI 1A at 6 PRB (27) and 100 PRB (44), format 2 at 100 PRB with 2 ports
# (51 + 16) and 4 ports (54 + 16); the UL long CQI (30 + 8); PBCH (40);
# NB-IoT NPDCCH (23 + 16), NPBCH (50) and NPDSCH at its largest TBS
# (680 + 24); sidelink MIB-SL (40 + 16) and SCI 0 at 100 PRB (45 + 16).
CALLER_LENGTHS = (27, 44, 67, 70, 38, 40, 39, 50, 704, 56, 61)


def assert_plan_covers(B, length, tail_biting):
    plan = viterbi_cuda.viterbi_plan(B, length, tail_biting)
    per_block = viterbi_cuda.CANDIDATES_PER_BLOCK
    assert plan.candidates_per_block == per_block
    assert plan.threads == 32 * per_block  # one warp per candidate
    # warp w of block x decodes candidate x * per_block + w: every candidate
    # in one slot, and no block without one (what the kernel's launch checks)
    assert (plan.blocks - 1) * per_block < B <= plan.blocks * per_block
    # per candidate: 8 bytes of decision words for each step the traceback
    # walks (the last two copies in tail-biting), 32 bytes of branch metrics
    # for each input step and for step 0 once more
    steps = (2 if tail_biting else 1) * length
    assert plan.smem_bytes == per_block * (8 * steps + 32 * (length + 1))
    assert plan.smem_bytes <= viterbi_cuda.SMEM_PER_BLOCK == 232448
    return plan


@pytest.mark.parametrize("tail_biting", [True, False], ids=["tail_biting", "pinned_start"])
@pytest.mark.parametrize("length", CALLER_LENGTHS)
def test_plan_every_caller_length(length, tail_biting):
    for B in BATCHES:
        assert_plan_covers(B, length, tail_biting)


def test_plan_numbers_at_the_paths_shapes():
    """The geometry `chip_smoke.py` launches at the DL's and UL's shapes."""
    dl = viterbi_cuda.viterbi_plan(2304, 44, True)
    assert (dl.blocks, dl.threads, dl.smem_bytes) == (2304, 32, 2144)
    ul = viterbi_cuda.viterbi_plan(128, 38, True)
    assert (ul.blocks, ul.threads, ul.smem_bytes) == (128, 32, 1856)


@pytest.mark.parametrize("tail_biting", [True, False], ids=["tail_biting", "pinned_start"])
def test_length_above_capacity_is_refused(tail_biting):
    """The longest code the kernel takes fills a block's shared memory as far
    as its layout allows and covers every caller; one bit more is refused by
    the plan (which the wrapper makes for a CUDA tensor, before any launch),
    as are an empty shape and one past the kernel's 32-bit indices."""
    longest = viterbi_cuda.max_length(tail_biting)
    assert longest >= max(CALLER_LENGTHS)
    plan = assert_plan_covers(3, longest, tail_biting)
    per_bit = viterbi_cuda.CANDIDATES_PER_BLOCK * (8 * (2 if tail_biting else 1) + 32)
    assert plan.smem_bytes + per_bit > viterbi_cuda.SMEM_PER_BLOCK
    for B, length in ((3, longest + 1), (0, 44), (3, 0), (2**31 // 132 + 1, 44)):
        with pytest.raises(ValueError):
            viterbi_cuda.viterbi_plan(B, length, tail_biting)


def test_cpu_decodes_above_capacity():
    """A CPU tensor goes to the plain version, which takes any length: a
    clean code word one bit longer than the kernel takes, its last 6 bits
    zero so that the tail-biting encoder starts in state 0, decodes to its
    bits with the start pinned there."""
    length = viterbi_cuda.max_length(False) + 1
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (1, length)).astype(np.uint8)
    bits[:, -6:] = 0
    llr = -(1.0 - 2.0 * t_conv.conv_encode_np(bits).astype(np.float32))
    got = viterbi_cuda.viterbi_decode(torch.as_tensor(llr), length, tail_biting=False)
    np.testing.assert_array_equal(got.numpy(), bits)


def test_plain_matches_reference_scan_at_longest_caller():
    """NB-IoT NPDSCH's 704 bits, tail-biting, noisy: the port's plain
    version (what the kernel is held to on the card) against the reference's
    radix-4 scan, bit for bit, as `test_torch_fec.py` does at 27 and 44."""
    length = 704
    rng = np.random.default_rng(length)
    bits = rng.integers(0, 2, (3, length)).astype(np.uint8)
    coded = j_conv.conv_encode_np(bits).astype(np.float32)
    llr = (-(1.0 - 2.0 * coded) + 0.8 * rng.standard_normal(coded.shape)).astype(np.float32)
    ref = np.asarray(j_conv.viterbi_decode(jnp.asarray(llr), length, tail_biting=True,
                                           backend="xla"))
    got = t_conv.viterbi_decode(llr, length, tail_biting=True, device="cpu")
    np.testing.assert_array_equal(got.numpy(), ref)
