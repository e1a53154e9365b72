"""Plain stand-in for the port's `ops/viterbi_cuda.py` at commit e4337f4: its
plain PyTorch Viterbi decoder (`viterbi_decode_plain`, copied unchanged with its
tables) on every device, in place of the CUDA kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

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


def viterbi_decode(llr, length: int, tail_biting: bool = True):
    """The port's `viterbi_decode`, on any device, by its plain version."""
    if llr.dim() != 2 or llr.shape[1] != 3 * length or length < 1:
        raise ValueError(f"llr must be [B, {3 * length}], got {tuple(llr.shape)}")
    if llr.dtype != torch.float32:
        raise TypeError(f"llr must be float32, got {llr.dtype}")
    return viterbi_decode_plain(llr.contiguous(), length, tail_biting)
