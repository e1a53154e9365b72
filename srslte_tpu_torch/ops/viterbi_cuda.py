"""Batched K=7 soft Viterbi decoder: CUDA kernel wrapper and plain version.

Replaces the Pallas kernel ``srslte_tpu/ops/viterbi_pallas.py``
``_viterbi_kernel`` (reached through ``viterbi_decode_pallas``).  The
semantics are that kernel's: radix-2 add-compare-select with no metric
normalisation, decision ``b > a`` (a tie keeps predecessor A), end state the
first maximum, tail-biting by a 3-fold repeat from a uniform start with the
middle copy emitted, and state 0 pinned at the start otherwise.

What bounds it on an H100: operations, about 270 per candidate and trellis
step against 12 input bytes.  At the DL path's shape (the PDCCH blind
search, 2304 candidates of 44 bits) the card's issue rate bounds the kernel
in ``csrc/viterbi.cu``; at the UL path's (128 long CQIs of 38 bits, about one
candidate per SM) the latency of each candidate's chain of dependent trellis
steps does.  What the design does about it: one warp per candidate, lane l
holding states l and l + 32, so a step on the chain is two shuffles, an add
and a max instead of 64 serial add-compare-selects; branch metrics staged
once per candidate in shared memory; the 64 decisions of a step taken by two
``__ballot_sync`` into shared memory, so nothing but the LLRs and the bits
goes through device memory; a warp reduction for the first maximum.
`viterbi_plan` gives the launch geometry, which the C launch checks.

`viterbi_decode_plain` is the same algorithm in PyTorch ops with the same tie
rules; it runs for a CPU tensor (at any length), and the kernel is held
against it on the card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import jit
from . import _build

GENS = (0o133, 0o171, 0o165)
TB_ITER = 3
NEG = -1e9
CANDIDATES_PER_BLOCK = 1  # warps per block, one candidate each (csrc/viterbi.cu CANDIDATES)
SMEM_PER_BLOCK = 232448  # dynamic shared bytes a block may use on sm_90


def _parity(x):
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


@functools.lru_cache(maxsize=1)
def _acs_tables():
    """pred [64, 2] and the branch-metric index code [64, 2] (o0 o1 o2 packed
    MSB first) of the branch into state sp from pred ((sp & 31) << 1) | b."""
    sp = np.arange(64)
    pred = np.stack([((sp & 31) << 1) | b for b in (0, 1)], axis=1)
    reg = ((sp >> 5) << 6)[:, None] | pred
    code = sum(_parity(reg & g) << (2 - k) for k, g in enumerate(GENS))
    signs = np.array([[1.0 if (c >> (2 - k)) & 1 else -1.0 for k in range(3)]
                      for c in range(8)], np.float32)
    return pred.astype(np.int64), code.astype(np.int64), signs


def viterbi_decode_plain(llr, length: int, tail_biting: bool = True):
    """Plain PyTorch version of `viterbi_decode` (same arguments and result)."""
    B = llr.shape[0]
    dev = llr.device
    pred, code, signs = (torch.as_tensor(t, device=dev) for t in _acs_tables())
    sym = llr.to(torch.float32).reshape(B, length, 3)
    if tail_biting:
        sym = torch.cat([sym] * TB_ITER, dim=1)
    T = sym.shape[1]
    m = torch.zeros((B, 64), dtype=torch.float32, device=dev)
    if not tail_biting:
        m[:, 1:] = NEG
    decs = torch.empty((T, B, 64), dtype=torch.bool, device=dev)
    for t in range(T):
        y = sym[:, t, None, :] * signs  # [B, 8, 3], +-y exactly
        g = (y[..., 0] + y[..., 1]) + y[..., 2]  # [B, 8]
        a = m[:, pred[:, 0]] + g[:, code[:, 0]]
        b = m[:, pred[:, 1]] + g[:, code[:, 1]]
        decs[t] = b > a  # a tie keeps predecessor A
        m = torch.maximum(a, b)
    state = torch.argmax(m, dim=1)  # the first maximum
    bits = torch.empty((B, T), dtype=torch.uint8, device=dev)
    for t in range(T - 1, -1, -1):
        bits[:, t] = (state >> 5).to(torch.uint8)
        bit = decs[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = ((state & 31) << 1) | bit
    if tail_biting:
        mid = (TB_ITER // 2) * length
        bits = bits[:, mid : mid + length]
    return bits.contiguous()


class ViterbiPlan(NamedTuple):
    """Launch geometry of the Viterbi kernel for one shape."""

    candidates_per_block: int  # one warp each
    blocks: int
    threads: int  # per block
    smem_bytes: int  # dynamic shared memory per block: decision words and branch metrics


def smem_per_candidate(length: int, tail_biting: bool) -> int:
    """Shared bytes of one candidate: 8 a step for the decision words of the
    steps the traceback walks (2 length in tail-biting, length otherwise)
    and 32 a step for the 8 branch metrics of each input step and of step 0
    again after the last."""
    return 8 * (2 if tail_biting else 1) * length + 32 * (length + 1)


def max_length(tail_biting: bool) -> int:
    """The longest code block the kernel takes."""
    return (SMEM_PER_BLOCK // CANDIDATES_PER_BLOCK - 32) // (8 * (2 if tail_biting else 1) + 32)


def viterbi_plan(B: int, length: int, tail_biting: bool) -> ViterbiPlan:
    """The kernel's launch geometry for B candidates of `length` bits;
    raises ValueError for a shape the kernel does not take.

    Warp w of block x decodes candidate x * CANDIDATES_PER_BLOCK + w; the
    blocks are as few as cover every candidate, which the kernel's launch
    checks, as it checks that the shared bytes are exactly its layout's."""
    if B < 1 or length < 1:
        raise ValueError(f"no Viterbi launch for B={B}, length={length}")
    if B * 3 * length >= 2**31:
        raise ValueError(f"B={B} x {3 * length} LLRs do not fit the kernel's 32-bit indices")
    smem = CANDIDATES_PER_BLOCK * smem_per_candidate(length, tail_biting)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"length {length} (tail_biting={tail_biting}) needs {smem} bytes of "
                         f"shared memory per block, more than the {SMEM_PER_BLOCK} a block may "
                         f"use: the kernel takes at most {max_length(tail_biting)} bits")
    blocks = -(-B // CANDIDATES_PER_BLOCK)
    return ViterbiPlan(CANDIDATES_PER_BLOCK, blocks, 32 * CANDIDATES_PER_BLOCK, smem)


@functools.lru_cache(maxsize=1)
def _lib():
    return _entry(_build.load("viterbi"))


def _entry(lib: ctypes.CDLL):
    fn = lib.viterbi_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fn, llr, length, tail_biting, plan):
    """One launch of the kernel entry `fn` on a checked CUDA tensor."""
    bits = torch.empty((llr.shape[0], length), dtype=torch.uint8, device=llr.device)
    with torch.cuda.device(llr.device):
        err = fn(llr.data_ptr(), bits.data_ptr(), llr.shape[0], length, int(tail_biting),
                 plan.blocks, plan.smem_bytes, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")
    return bits


def viterbi_decode(llr, length: int, tail_biting: bool = True):
    """llr [B, 3*length] float32 (positive => bit 1) -> bits [B, length] uint8.

    A CUDA tensor goes to the kernel, under `viterbi_plan`'s geometry (which
    refuses a length above the kernel's capacity); a CPU tensor to
    `viterbi_decode_plain`.
    """
    if llr.dim() != 2 or llr.shape[1] != 3 * length or length < 1:
        raise ValueError(f"llr must be [B, {3 * length}], got {tuple(llr.shape)}")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    if not llr.is_contiguous():
        raise ValueError("llr must be contiguous")
    if llr.device.type == "cpu":
        return viterbi_decode_plain(llr, length, tail_biting)
    if llr.device.type != "cuda":
        raise RuntimeError(f"no Viterbi kernel for device {llr.device}")
    bits = _launch(_lib(), llr, length, tail_biting, viterbi_plan(llr.shape[0], length,
                                                                  tail_biting))
    viterbi_decode.launches += 1
    viterbi_decode.shapes[("viterbi_decode", f"B={llr.shape[0]} len={length} "
                                             f"tail_biting={bool(tail_biting)}")] += 1
    return bits


def blocks_per_sm(plan: ViterbiPlan, lib: ctypes.CDLL | None = None) -> int:
    """Resident blocks per SM of the kernel (of `lib`, by default the built
    source) under `plan`, as the CUDA runtime computes it on the current
    device (a measurement aid; launches nothing)."""
    fn = (lib or _build.load("viterbi")).viterbi_blocks_per_sm
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    result = ctypes.c_int(0)
    err = fn(plan.smem_bytes, ctypes.byref(result))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return result.value


viterbi_decode.launches = 0  # kernel launches made by this process (and replayed)
viterbi_decode.shapes = collections.Counter()  # by (kernel, shape)
jit.count_launches(viterbi_decode, "launches", "shapes")
