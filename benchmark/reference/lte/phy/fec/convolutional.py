# Frozen copy of srslte_tpu_torch/phy/fec/convolutional.py at commit e4337f4, unchanged but for this line.
"""Tail-biting convolutional code K=7 rate 1/3 + Viterbi decoder (36.212 §5.1.3.1).

Reference behavior: lib/src/phy/fec/convolutional/{convcoder.c, viterbi.c,
viterbi37_port.c}.  Generators G = (133, 171, 165) octal; tail-biting decode
follows the C library's wrap-around scheme (viterbi.c:66-71): repeat the
received sequence TB_ITER=3 times, run one Viterbi pass, keep the middle copy.

The encoder is a GF(2) matrix product per static length bucket (tail-biting
keeps it linear); the decoder is the CUDA kernel behind
`ops.viterbi_cuda.viterbi_decode`.  Throughput comes from batching many
blocks (all PDCCH blind-search candidates at once).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table
from ...ops import viterbi_cuda
from ...ops.viterbi_cuda import GENS, TB_ITER  # noqa: F401  (one definition)
from .crc import gf2_matmul

K_CONV = 7
RATE = 3

_NSTATES = 64


def _parity(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & 1


@functools.lru_cache(maxsize=1)
def _branch_tables():
    """OUT[u, s, 3] output bits and NEXT[u, s] for reg = (u<<6)|s, s MSB-newest."""
    u = np.arange(2)[:, None]
    s = np.arange(_NSTATES)[None, :]
    reg = (u << 6) | s
    out = np.stack([_parity(reg & g) for g in GENS], axis=-1)  # [2, 64, 3]
    nxt = ((u << 5) | (s >> 1)).astype(np.int32)  # [2, 64]
    return out.astype(np.int32), nxt


def conv_encode_np(bits: np.ndarray) -> np.ndarray:
    """Host tail-biting encoder: bits [..., L] -> coded [..., 3L].

    Initial state = last 6 input bits (convcoder.c:50-56), so the trellis
    starts and ends in the same state.
    """
    out_tab, nxt = _branch_tables()
    L = bits.shape[-1]
    # state s holds (c_{i-1}..c_{i-6}), newest at bit 5
    state = np.zeros(bits.shape[:-1], np.int32)
    for i in range(L - 6, L):
        state = (state >> 1) | (bits[..., i].astype(np.int32) << 5)
    out = np.empty(bits.shape[:-1] + (3 * L,), np.uint8)
    for i in range(L):
        u = bits[..., i].astype(np.int32)
        out[..., 3 * i : 3 * i + 3] = out_tab[u, state]
        state = nxt[u, state]
    return out


@functools.lru_cache(maxsize=None)
def _encoder_matrix(length: int) -> np.ndarray:
    eye = np.eye(length, dtype=np.uint8)
    return conv_encode_np(eye)


def conv_encode(bits, length: int, device=None):
    """Device encoder: one matrix product (linear incl. tail-biting init)."""
    bits = as_tensor(bits, device)
    return gf2_matmul(bits, ("conv_g", length),
                      lambda: _encoder_matrix(length)).to(torch.uint8)


def viterbi_decode(llr, length: int, tail_biting: bool = True, device=None):
    """Batched soft Viterbi: llr [B, 3L] (positive => bit 1) -> bits [B, L] uint8.

    Tail-biting wrap-around per viterbi.c: the sequence is processed TB_ITER
    times and the middle copy is returned.  A CUDA tensor is decoded by the
    kernel, a CPU tensor by its plain PyTorch version
    (`ops.viterbi_cuda.viterbi_decode_plain`).
    """
    llr = as_tensor(llr, device, torch.float32).contiguous()
    return viterbi_cuda.viterbi_decode(llr, length, tail_biting)


# ---------------------------------------------------- conv rate matching
NCOLS = 32
RM_PERM_CC = np.array([1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
                       0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30], np.int64)


@functools.lru_cache(maxsize=None)
def rm_conv_indices(coded_len: int, e: int) -> np.ndarray:
    """36.212 §5.1.4.2 conv rate matching: gather table [E] into coded [3D].

    Each of the 3 streams (length D = coded_len/3) is sub-block interleaved
    with the CC permutation; w = [v0; v1; v2]; e cycles skipping dummies.
    """
    d = coded_len // 3
    nrows = -(-d // NCOLS)
    kp = nrows * NCOLS
    nd = kp - d
    pad = np.concatenate([np.full(nd, -1, np.int64), np.arange(d)])
    v = pad.reshape(nrows, NCOLS)[:, RM_PERM_CC].T.reshape(-1)  # [Kp]
    # coded is time-major (convcoder.c output[3i+j]): stream s, pos i -> 3i+s
    w = np.concatenate([np.where(v >= 0, 3 * v + s, -1) for s in range(3)])
    sel = w[w >= 0]
    reps = -(-e // len(sel))
    return np.tile(sel, reps)[:e].astype(np.int32)


def rm_conv_tx(coded, e: int, device=None):
    coded = as_tensor(coded, device)
    n = coded.shape[-1]
    idx = table(("rm_conv", n, e), coded.device,
                lambda: rm_conv_indices(n, e).astype(np.int64))
    return coded[..., idx]


@functools.lru_cache(maxsize=None)
def _rm_conv_rx_inverse(coded_len: int, e: int):
    """Inverse of rm_conv_indices as a gather table [coded_len, R]
    (-1 padded): repetition combining is a masked gather-sum."""
    idx = rm_conv_indices(coded_len, e)
    counts = np.bincount(idx, minlength=coded_len)
    r = max(1, int(counts.max()))
    inv = np.full((coded_len, r), -1, np.int64)
    fill = np.zeros(coded_len, np.int64)
    for j, pos in enumerate(idx):
        inv[pos, fill[pos]] = j
        fill[pos] += 1
    return inv.astype(np.int32), (inv >= 0).astype(np.float32)


def rm_conv_rx(e_llr, coded_len: int, device=None):
    e_llr = as_tensor(e_llr, device)
    e = e_llr.shape[-1]
    inv = table(("rm_conv_inv", coded_len, e), e_llr.device, lambda: np.maximum(
        _rm_conv_rx_inverse(coded_len, e)[0], 0).astype(np.int64))
    mask = table(("rm_conv_mask", coded_len, e), e_llr.device,
                 lambda: _rm_conv_rx_inverse(coded_len, e)[1])
    return torch.sum(e_llr[..., inv] * mask, dim=-1).to(e_llr.dtype)
