"""Batched K=7 soft Viterbi decoder: CUDA kernel wrapper and plain version.

Replaces the Pallas kernel ``srslte_tpu/ops/viterbi_pallas.py``
``_viterbi_kernel`` (reached through ``viterbi_decode_pallas``).  The
semantics are that kernel's: radix-2 add-compare-select with no metric
normalisation, decision ``b > a`` (a tie keeps predecessor A), end state the
first maximum, tail-biting by a 3-fold repeat from a uniform start with the
middle copy emitted, and state 0 pinned at the start otherwise.

What bounds it on an H100: operations, about 270 per candidate and trellis
step against 12 input bytes; at the PDCCH blind search's size (a few thousand
candidates) the kernel in ``csrc/viterbi.cu`` is bound by latency instead,
since one thread walks one candidate's trellis and the batch fills only part
of the card.  What the design does about it: the 64 path metrics stay in
registers, the 64 decisions of a step are one 64-bit word in a
[step][candidate] scratch tensor, and the traceback is integer arithmetic.
Splitting a candidate's states across the lanes of a warp is later work.

`viterbi_decode_plain` is the same algorithm in PyTorch ops with the same tie
rules; it runs for a CPU tensor, and the kernel is held against it on the
card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import _build

GENS = (0o133, 0o171, 0o165)
TB_ITER = 3
NEG = -1e9


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


@functools.lru_cache(maxsize=1)
def _lib():
    lib = _build.load("viterbi")
    fn = lib.viterbi_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def viterbi_decode(llr, length: int, tail_biting: bool = True):
    """llr [B, 3*length] float32 (positive => bit 1) -> bits [B, length] uint8.

    A CUDA tensor goes to the kernel; a CPU tensor to `viterbi_decode_plain`.
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
    B = llr.shape[0]
    steps = (TB_ITER if tail_biting else 1) * length
    bits = torch.empty((B, length), dtype=torch.uint8, device=llr.device)
    dec = torch.empty((steps, B), dtype=torch.int64, device=llr.device)
    with torch.cuda.device(llr.device):
        err = _lib()(llr.data_ptr(), bits.data_ptr(), dec.data_ptr(), B, length,
                     int(tail_biting), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"viterbi kernel launch failed: CUDA error {err}")
    viterbi_decode.launches += 1
    return bits


viterbi_decode.launches = 0  # kernel launches made by this process
