# Frozen copy of srslte_tpu_torch/phy/fec/cbsegm.py at commit e4337f4, unchanged but for this line.
"""Code block segmentation (36.212 §5.1.2).

Reference behavior: lib/src/phy/fec/cbsegm.c (srsran_cbsegm).  The 188 turbo
interleaver sizes are generated from the spec's arithmetic progressions
(40:8:512, 528:16:1024, 1056:32:2048, 2112:64:6144).
"""

from __future__ import annotations

import bisect
import functools
from dataclasses import dataclass

MAX_CB_SIZE = 6144
TB_CRC_LEN = 24  # CRC24A
CB_CRC_LEN = 24  # CRC24B


@functools.lru_cache(maxsize=1)
def cb_sizes() -> tuple[int, ...]:
    """All 188 valid turbo code block sizes K (36.212 table 5.1.3-3)."""
    sizes = list(range(40, 513, 8)) + list(range(528, 1025, 16)) \
        + list(range(1056, 2049, 32)) + list(range(2112, 6145, 64))
    assert len(sizes) == 188
    return tuple(sizes)


def cb_index(k: int) -> int:
    """Index of CB size K in the 188-entry table (cbsegm.c srsran_cbsegm_cbindex)."""
    sizes = cb_sizes()
    i = bisect.bisect_left(sizes, k)
    if i == len(sizes) or sizes[i] != k:
        raise ValueError(f"invalid turbo CB size {k}")
    return i


@dataclass(frozen=True)
class CbSegm:
    """Segmentation of a transport block of tbs bits (before TB CRC)."""

    tbs: int  # transport block size (payload bits, no CRC)
    C: int  # number of code blocks
    K1: int  # larger CB size (K+)
    K2: int  # smaller CB size (K-), 0 if unused
    C1: int  # number of CBs of size K1
    C2: int  # number of CBs of size K2
    F: int  # filler bits (prepended to first CB)

    @property
    def K1_idx(self) -> int:
        return cb_index(self.K1)

    @property
    def K2_idx(self) -> int:
        return cb_index(self.K2) if self.K2 else -1


def cbsegm(tbs: int) -> CbSegm:
    """36.212 §5.1.2 (matches cbsegm.c:62 srsran_cbsegm)."""
    sizes = cb_sizes()
    b = tbs + TB_CRC_LEN  # B: TB + TB CRC
    if b <= MAX_CB_SIZE:
        L, C, b_prime = 0, 1, b
    else:
        L = CB_CRC_LEN
        C = -(-b // (MAX_CB_SIZE - L))
        b_prime = b + C * L

    # K+ = smallest K with C*K >= B'
    i = bisect.bisect_left(sizes, -(-b_prime // C))
    k1 = sizes[i]
    if C == 1:
        k2, c1, c2 = 0, 1, 0
    else:
        k2 = sizes[i - 1] if i > 0 else 0
        dk = k1 - k2 if k2 else 1
        c2 = (C * k1 - b_prime) // dk if k2 else 0
        c1 = C - c2
        if c2 == 0:
            k2 = 0
    f = c1 * k1 + c2 * k2 - b_prime
    return CbSegm(tbs=tbs, C=C, K1=k1, K2=k2, C1=c1, C2=c2, F=f)
