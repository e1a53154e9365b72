# Frozen copy of srslte_tpu_torch/phy/fec/crc.py at commit e4337f4, unchanged but for this line.
"""LTE CRC engines (36.212 §5.1.1).

Reference behavior: lib/src/phy/fec/crc.c (byte-table LFSR).  CRC over GF(2)
is linear with zero init, so for each static message length a [len, order]
generator matrix G with G[i] = CRC(e_i) is precomputed; on the device a batch
of messages is checked with one matrix product and a parity mask instead of a
sequential LFSR.  The host-side numpy LFSR is kept for table building and tests.

The product runs in float32: every sum is at most the message length
(63800 < 2^24 for the largest transport block), so it is exact as long as
``torch.backends.cuda.matmul.allow_tf32`` stays False, which is PyTorch's
default and which this package never changes.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table

# 36.212 §5.1.1 generator polynomials (including leading x^order term)
LTE_CRC24A = (0x1864CFB, 24)
LTE_CRC24B = (0x1800063, 24)
NR_CRC24C = (0x1B2B117, 24)  # 38.212 §5.1 (PBCH/PDCCH NR)
NR_CRC11 = (0xE21, 11)  # 38.212 §5.1 (UCI 20 <= A)
NR_CRC6 = (0x61, 6)  # 38.212 §5.1 (UCI 12 <= A <= 19)
LTE_CRC16 = (0x11021, 16)
LTE_CRC12 = (0x180F, 12)  # used by NB-IoT / legacy
LTE_CRC8 = (0x19B, 8)


def crc_bits(bits: np.ndarray, poly: int, order: int) -> np.ndarray:
    """Host CRC: bits [..., len] uint8 -> crc bits [..., order] (MSB first)."""
    bits = np.asarray(bits, dtype=np.uint8)
    rem = np.zeros(bits.shape[:-1], dtype=np.uint64)
    mask = np.uint64((1 << order) - 1)
    top = np.uint64(1 << (order - 1))
    p = np.uint64(poly & ((1 << order) - 1))
    for i in range(bits.shape[-1]):
        fb = ((rem & top) != 0) ^ (bits[..., i] != 0)
        rem = ((rem << np.uint64(1)) & mask) ^ np.where(fb, p, np.uint64(0))
    out = (rem[..., None] >> np.arange(order - 1, -1, -1, dtype=np.uint64)) & np.uint64(1)
    return out.astype(np.uint8)


def crc_attach(bits: np.ndarray, poly: int, order: int) -> np.ndarray:
    return np.concatenate([bits, crc_bits(bits, poly, order)], axis=-1)


@functools.lru_cache(maxsize=None)
def crc_matrix(length: int, poly: int, order: int) -> np.ndarray:
    """G such that CRC(m) = (m @ G) mod 2, shape [length, order], uint8 (MSB first).

    Row i = x^(order + length-1-i) mod poly, i.e. the CRC of the unit message
    with bit i set.  Built back-to-front with one shift-and-reduce per row.
    """
    g = np.zeros((length, order), dtype=np.uint8)
    pbits = [(poly >> k) & 1 for k in range(order - 1, -1, -1)]  # poly low bits, MSB first
    # r = x^order mod poly  (CRC of the 1-bit message [1])
    r = list(pbits)
    g[length - 1] = r
    for i in range(length - 2, -1, -1):
        # r <- x * r mod poly
        msb = r[0]
        r = r[1:] + [0]
        if msb:
            r = [a ^ b for a, b in zip(r, pbits)]
        g[i] = r
    return g


def gf2_matmul(bits, key, build):
    """(bits @ G) mod 2 for a cached 0/1 matrix G: float32 product, exact."""
    g = table(key, bits.device, build, dtype=torch.float32)
    return torch.remainder(torch.matmul(bits.to(torch.float32), g), 2.0)


def crc_calc(msg, poly: int, order: int):
    """CRC bits [..., order] (float32 0/1) of msg [..., k] on the device."""
    k = msg.shape[-1]
    return gf2_matmul(msg, ("crc", k, poly, order),
                      lambda: crc_matrix(k, poly, order))


def crc_ok_device(bits_with_crc, poly: int, order: int, rnti_mask=None,
                  device=None):
    """Batched CRC check: bits [..., K+order] {0,1} -> bool [...].

    One matrix product per static K bucket.  `rnti_mask` (optional, [order]
    or broadcastable) is XORed into the received CRC before comparison: the
    PDCCH/PBCH RNTI-scrambled CRC idiom (pdcch.c dci_decode).
    """
    bits_with_crc = as_tensor(bits_with_crc, device)
    k = bits_with_crc.shape[-1] - order
    calc = crc_calc(bits_with_crc[..., :k], poly, order).to(torch.int32)
    rx = bits_with_crc[..., k:].to(torch.int32)
    if rnti_mask is not None:
        rx = rx ^ as_tensor(rnti_mask, bits_with_crc.device).to(torch.int32)
    return torch.all(calc == rx, dim=-1)
