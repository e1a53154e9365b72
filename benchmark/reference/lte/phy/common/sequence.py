# Frozen copy of srslte_tpu_torch/phy/common/sequence.py at commit e4337f4, unchanged but for this line.
"""LTE Gold (pseudo-random) sequence generation, 36.211 §7.2.

Reference behavior: lib/src/phy/common/sequence.c (srsran_sequence_LTE_pr).
The 31-bit LFSR state words double as 31-output blocks (output bit
c(n) = x1(n) ^ x2(n), and the low bit of the state IS the next output), so
generation is a loop over ceil(len/31) block steps of integer bitwise ops.
Sequences are config-time tables (seeds are known per cell/RNTI/subframe):
they are built on the host with numpy and uploaded once per device.  For a
seed that is only known on the device, `gold_sequence_device` computes the
sequence as one GF(2) matrix product.

Sign convention (sequence.c:360): bit 0 -> +1.0, bit 1 -> -1.0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor
from ..fec.crc import gf2_matmul

NC = 1600  # fast-forward length per 36.211 §7.2

_M28 = (1 << 28) - 1
_M31 = (1 << 31) - 1


def _x1_step(s: int) -> int:
    """Advance x1 state (bits x(n)..x(n+30)) one step: x(n+31)=x(n+3)^x(n)."""
    new = ((s >> 3) ^ s) & 1
    return (s >> 1) | (new << 30)


def _x2_step(s: int) -> int:
    """x2(n+31) = x2(n+3)^x2(n+2)^x2(n+1)^x2(n)."""
    new = ((s >> 3) ^ (s >> 2) ^ (s >> 1) ^ s) & 1
    return (s >> 1) | (new << 30)


def _x1_step31(s):
    """Advance x1 31 steps: the new state's 31 bits are x(n+31)..x(n+61)."""
    new = ((s >> 3) ^ s) & _M28  # bits x(n+31..n+58)
    new = new | ((((s >> 28) ^ new) & 0x7) << 28)  # x(n+59..61) use fresh bits
    return new & _M31


def _x2_step31(s):
    new = ((s >> 3) ^ (s >> 2) ^ (s >> 1) ^ s) & _M28  # bits x(n+31..n+58)
    # bits x(n+59..61) at positions 28..30 reuse fresh bits new_0..new_2:
    #   pos28 = new0^s28^s29^s30, pos29 = new0^new1^s29^s30, pos30 = new0^new1^new2^s30
    hi = ((new << 28) ^ (new << 29) ^ (new << 30) ^ s ^ (s >> 1) ^ (s >> 2)) & (0x7 << 28)
    return (new | hi) & _M31


@functools.lru_cache(maxsize=1)
def _x1_nc_state() -> int:
    s = 1  # x1 init: x1(0)=1, rest 0
    for _ in range(NC):
        s = _x1_step(s)
    return s


@functools.lru_cache(maxsize=None)
def _x2_nc_state(seed: int) -> int:
    s = int(seed) & _M31
    for _ in range(NC):
        s = _x2_step(s)
    return s


def gold_sequence(seed: int, length: int) -> np.ndarray:
    """Generate c(0..length-1) as uint8 bits (host/numpy, config-time)."""
    nblocks = -(-length // 31)
    x1 = _x1_nc_state()
    x2 = _x2_nc_state(seed)
    words = np.empty(nblocks, dtype=np.uint32)
    for i in range(nblocks):
        words[i] = x1 ^ x2
        x1 = _x1_step31(x1)
        x2 = _x2_step31(x2)
    # unpack 31 LSB-first bits per word
    bits = (words[:, None] >> np.arange(31, dtype=np.uint32)[None, :]) & 1
    return bits.reshape(-1)[:length].astype(np.uint8)


def gold_sequence_signed(seed: int, length: int) -> np.ndarray:
    """+1.0 for bit 0, -1.0 for bit 1 (sequence.c:360 convention)."""
    return (1.0 - 2.0 * gold_sequence(seed, length)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _gold_linear_map(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(A [31, length] uint8, x1 [length] uint8): c = (seed_bits @ A) ^ x1.

    The Nc fast-forward and every 31-bit block step of x2 are linear over
    GF(2), and x1 does not depend on the seed, so output bit n is a fixed
    GF(2) combination of the seed's 31 bits XOR x1's bit n.  Row j of A is
    the x2 stream of seed 2^j (x1 cancels in the XOR with seed 0)."""
    x1 = gold_sequence(0, length)
    a = np.stack([gold_sequence(1 << j, length) ^ x1 for j in range(31)])
    return a, x1


def gold_sequence_device(seed, length: int, device=None) -> torch.Tensor:
    """Gold sequence for seeds held in a tensor: seed [...] (integer) ->
    uint8 bits [..., length] on the seed's device.

    The counterpart of the JAX package's ``gold_sequence_jax`` (a scan of
    block steps after a loop of Nc single steps): here one float32 product
    of the seed's 31 bits with a GF(2) matrix built on the host (exact: every
    sum is at most 31), then the XOR with the seed-independent x1 stream."""
    seed = as_tensor(seed, device).to(torch.int64)
    bits = (seed[..., None] >> torch.arange(31, device=seed.device)) & 1
    c = gf2_matmul(bits, ("gold_a", length), lambda: _gold_linear_map(length)[0])
    x1 = as_tensor(_gold_linear_map(length)[1], seed.device)
    return c.to(torch.uint8) ^ x1
