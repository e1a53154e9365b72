"""SSS generation (36.211 §6.11.2).

Reference behavior: lib/src/phy/sync/sss.c (sequence tables,
srsran_sss_generate).  Detection (`sss_find`) belongs to the blind receiver,
ROADMAP queue A item 7.
"""

from __future__ import annotations

import functools

import numpy as np

SSS_LEN = 62


def _lfsr31(taps: tuple[int, ...]) -> np.ndarray:
    """x(i+5) = sum_taps x(i+t) mod 2, x = (0,0,0,0,1); returns ±1 floats."""
    x = np.zeros(31, np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in taps) % 2
    return (1 - 2 * x).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _seqs():
    s = _lfsr31((2, 0))  # s̃: x(i+5)=x(i+2)+x(i)
    c = _lfsr31((3, 0))  # c̃: x(i+5)=x(i+3)+x(i)
    z = _lfsr31((4, 2, 1, 0))  # z̃: x(i+5)=x(i+4)+x(i+2)+x(i+1)+x(i)
    return s, c, z


def m0m1(n_id_1: int) -> tuple[int, int]:
    """36.211 table 6.11.2.1-1 generation rule."""
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


def sss_sequence(n_id_1: int, n_id_2: int, sf5: bool) -> np.ndarray:
    """SSS d(0..61) as ±1 float32 for subframe 0 (sf5=False) or 5 (sf5=True)."""
    s, c, z = _seqs()
    m0, m1 = m0m1(n_id_1)
    n = np.arange(31)
    s0 = s[(n + m0) % 31]
    s1 = s[(n + m1) % 31]
    c0 = c[(n + n_id_2) % 31]
    c1 = c[(n + n_id_2 + 3) % 31]
    z1_m0 = z[(n + (m0 % 8)) % 31]
    z1_m1 = z[(n + (m1 % 8)) % 31]
    d = np.empty(SSS_LEN, np.float32)
    if not sf5:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1_m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1_m1
    return d
