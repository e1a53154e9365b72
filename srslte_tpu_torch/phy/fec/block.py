"""(32, k) short block code (36.212 §5.2.2.6.4, fec/block/block.c).

Used by UCI on PUSCH for payloads up to 11 bits.  Encoding is a GF(2) basis
combination on the host; decoding correlates LLRs against the full 2^k
codebook in one matrix product (the C library builds the same LUT,
block.c:57).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table

# 36.212 table 5.2.2.6.4-1 basis sequences (row i = 11 basis bits of output i)
_BASIS_WORDS = [
    0b10000000011, 0b11000000111, 0b11101001001, 0b10100001101, 0b10010001111,
    0b10111010011, 0b11101010101, 0b10110011001, 0b11010011011, 0b11001011101,
    0b11011100101, 0b10101100111, 0b11110101001, 0b11010101011, 0b10010110001,
    0b11011110011, 0b01001110111, 0b00100111001, 0b00011111011, 0b00001100001,
    0b10001000101, 0b11000001011, 0b10110010001, 0b11100010111, 0b01111011111,
    0b10011100011, 0b01100101101, 0b01110101111, 0b00101110101, 0b00111111101,
    0b11111111111, 0b00000000001,
]
BLOCK_SIZE = 32
MAX_BITS = 11


@functools.lru_cache(maxsize=1)
def _basis() -> np.ndarray:
    """[32, 11] basis matrix; input bit n multiplies column n."""
    m = np.zeros((BLOCK_SIZE, MAX_BITS), np.uint8)
    for i, w in enumerate(_BASIS_WORDS):
        for n in range(MAX_BITS):
            m[i, n] = (w >> n) & 1
    return m


def block_encode(bits: np.ndarray, e: int = BLOCK_SIZE) -> np.ndarray:
    """Host encoder: bits [..., k<=11] -> codeword [..., e] (cyclic
    repetition past 32)."""
    bits = np.asarray(bits, np.uint8)
    k = bits.shape[-1]
    cw = (bits @ _basis()[:, :k].T) % 2
    reps = -(-e // BLOCK_SIZE)
    return np.tile(cw, (1,) * (bits.ndim - 1) + (reps,))[..., :e]


@functools.lru_cache(maxsize=None)
def _codebook(k: int) -> np.ndarray:
    msgs = (np.arange(2**k)[:, None] >> np.arange(k)[None, :]) & 1
    cws = (msgs.astype(np.uint8) @ _basis()[:, :k].T) % 2
    return (1.0 - 2.0 * cws).astype(np.float32)  # ±1, +1 = bit 0


def block_decode(llr, k: int, device=None):
    """llr [..., E] (positive => bit 1) -> (bits [..., k] uint8, corr metric).

    Soft ML decode: fold repetitions onto the 32 base positions, correlate
    against all 2^k codewords (one matrix product), take the first maximum.
    """
    llr = as_tensor(llr, device, torch.float32)
    e = llr.shape[-1]
    reps = -(-e // BLOCK_SIZE)
    pad = llr.new_zeros(llr.shape[:-1] + (reps * BLOCK_SIZE - e,))
    folded = torch.cat([llr, pad], -1).reshape(
        llr.shape[:-1] + (reps, BLOCK_SIZE)).sum(dim=-2)
    cb = table(("block_codebook", k), llr.device, lambda: _codebook(k))
    corr = -(folded @ cb.T)
    best = torch.argmax(corr, dim=-1)
    shifts = torch.arange(k, device=llr.device)
    bits = ((best[..., None] >> shifts) & 1).to(torch.uint8)
    metric = torch.gather(corr, -1, best[..., None])[..., 0]
    return bits, metric
