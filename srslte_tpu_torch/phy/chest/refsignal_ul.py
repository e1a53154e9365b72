"""Uplink demodulation reference signals (36.211 §5.5, refsignal_ul.c).

Reference behavior: lib/src/phy/ch_estimation/refsignal_ul.c — base sequences
r̄_u,v from Zadoff-Chu cyclic extension (M >= 36), group number
u = (f_gh + f_ss) mod 30 (group hopping off by default), PUSCH cyclic-shift
hopping n_PN(ns) from the Gold sequence, DMRS on SC-FDMA symbol 3 of each
slot (normal CP).

Host-side numpy (config-time tables per cell/slot), uploaded once and
applied on the device.  1-2 PRB allocations use the special QPSK phase
tables (3GPP spec constants, 36.211 tables 5.5.1.2-1 and 5.5.1.2-2).
"""

from __future__ import annotations

import functools

import numpy as np

from ..common.params import Cell
from ..common.sequence import gold_sequence
from ..common.zc import zadoff_chu

NRE = 12


def _largest_prime_below(n: int) -> int:
    for c in range(n - 1, 1, -1):
        if all(c % d for d in range(2, int(c**0.5) + 1)):
            return c
    raise ValueError(n)


# 36.211 table 5.5.1.2-1: phi(n) for M_sc = 12 (values scale pi/4)
_PHI_M12 = np.array([
    [-1, 1, 3, -3, 3, 3, 1, 1, 3, 1, -3, 3], [1, 1, 3, 3, 3, -1, 1, -3, -3, 1, -3, 3],
    [1, 1, -3, -3, -3, -1, -3, -3, 1, -3, 1, -1], [-1, 1, 1, 1, 1, -1, -3, -3, 1, -3, 3, -1],
    [-1, 3, 1, -1, 1, -1, -3, -1, 1, -1, 1, 3], [1, -3, 3, -1, -1, 1, 1, -1, -1, 3, -3, 1],
    [-1, 3, -3, -3, -3, 3, 1, -1, 3, 3, -3, 1], [-3, -1, -1, -1, 1, -3, 3, -1, 1, -3, 3, 1],
    [1, -3, 3, 1, -1, -1, -1, 1, 1, 3, -1, 1], [1, -3, -1, 3, 3, -1, -3, 1, 1, 1, 1, 1],
    [-1, 3, -1, 1, 1, -3, -3, -1, -3, -3, 3, -1], [3, 1, -1, -1, 3, 3, -3, 1, 3, 1, 3, 3],
    [1, -3, 1, 1, -3, 1, 1, 1, -3, -3, -3, 1], [3, 3, -3, 3, -3, 1, 1, 3, -1, -3, 3, 3],
    [-3, 1, -1, -3, -1, 3, 1, 3, 3, 3, -1, 1], [3, -1, 1, -3, -1, -1, 1, 1, 3, 1, -1, -3],
    [1, 3, 1, -1, 1, 3, 3, 3, -1, -1, 3, -1], [-3, 1, 1, 3, -3, 3, -3, -3, 3, 1, 3, -1],
    [-3, 3, 1, 1, -3, 1, -3, -3, -1, -1, 1, -3], [-1, 3, 1, 3, 1, -1, -1, 3, -3, -1, -3, -1],
    [-1, -3, 1, 1, 1, 1, 3, 1, -1, 1, -3, -1], [-1, 3, -1, 1, -3, -3, -3, -3, -3, 1, -1, -3],
    [1, 1, -3, -3, -3, -3, -1, 3, -3, 1, -3, 3], [1, 1, -1, -3, -1, -3, 1, -1, 1, 3, -1, 1],
    [1, 1, 3, 1, 3, 3, -1, 1, -1, -3, -3, 1], [1, -3, 3, 3, 1, 3, 3, 1, -3, -1, -1, 3],
    [1, 3, -3, -3, 3, -3, 1, -1, -1, 3, -1, -3], [-3, -1, -3, -1, -3, 3, 1, -1, 1, 3, -3, -3],
    [-1, 3, -3, 3, -1, 3, 3, -3, 3, 3, -1, -1], [3, -3, -3, -1, -1, -3, -1, 3, -3, 3, 1, -1],
], np.float64)

# 36.211 table 5.5.1.2-2: phi(n) for M_sc = 24
_PHI_M24 = np.array([
    [-1, 3, 1, -3, 3, -1, 1, 3, -3, 3, 1, 3, -3, 3, 1, 1, -1, 1, 3, -3, 3, -3, -1, -3],
    [-3, 3, -3, -3, -3, 1, -3, -3, 3, -1, 1, 1, 1, 3, 1, -1, 3, -3, -3, 1, 3, 1, 1, -3],
    [3, -1, 3, 3, 1, 1, -3, 3, 3, 3, 3, 1, -1, 3, -1, 1, 1, -1, -3, -1, -1, 1, 3, 3],
    [-1, -3, 1, 1, 3, -3, 1, 1, -3, -1, -1, 1, 3, 1, 3, 1, -1, 3, 1, 1, -3, -1, -3, -1],
    [-1, -1, -1, -3, -3, -1, 1, 1, 3, 3, -1, 3, -1, 1, -1, -3, 1, -1, -3, -3, 1, -3, -1, -1],
    [-3, 1, 1, 3, -1, 1, 3, 1, -3, 1, -3, 1, 1, -1, -1, 3, -1, -3, 3, -3, -3, -3, 1, 1],
    [1, 1, -1, -1, 3, -3, -3, 3, -3, 1, -1, -1, 1, -1, 1, 1, -1, -3, -1, 1, -1, 3, -1, -3],
    [-3, 3, 3, -1, -1, -3, -1, 3, 1, 3, 1, 3, 1, 1, -1, 3, 1, -1, 1, 3, -3, -1, -1, 1],
    [-3, 1, 3, -3, 1, -1, -3, 3, -3, 3, -1, -1, -1, -1, 1, -3, -3, -3, 1, -3, -3, -3, 1, -3],
    [1, 1, -3, 3, 3, -1, -3, -1, 3, -3, 3, 3, 3, -1, 1, 1, -3, 1, -1, 1, 1, -3, 1, 1],
    [-1, 1, -3, -3, 3, -1, 3, -1, -1, -3, -3, -3, -1, -3, -3, 1, -1, 1, 3, 3, -1, 1, -1, 3],
    [1, 3, 3, -3, -3, 1, 3, 1, -1, -3, -3, -3, 3, 3, -3, 3, 3, -1, -3, 3, -1, 1, -3, 1],
    [1, 3, 3, 1, 1, 1, -1, -1, 1, -3, 3, -1, 1, 1, -3, 3, 3, -1, -3, 3, -3, -1, -3, -1],
    [3, -1, -1, -1, -1, -3, -1, 3, 3, 1, -1, 1, 3, 3, 3, -1, 1, 1, -3, 1, 3, -1, -3, 3],
    [-3, -3, 3, 1, 3, 1, -3, 3, 1, 3, 1, 1, 3, 3, -1, -1, -3, 1, -3, -1, 3, 1, 1, 3],
    [-1, -1, 1, -3, 1, 3, -3, 1, -1, -3, -1, 3, 1, 3, 1, -1, -3, -3, -1, -1, -3, -3, -3, -1],
    [-1, -3, 3, -1, -1, -1, -1, 1, 1, -3, 3, 1, 3, 3, 1, -1, 1, -3, 1, -3, 1, 1, -3, -1],
    [1, 3, -1, 3, 3, -1, -3, 1, -1, -3, 3, 3, 3, -1, 1, 1, 3, -1, -3, -1, 3, -1, -1, -1],
    [1, 1, 1, 1, 1, -1, 3, -1, -3, 1, 1, 3, -3, 1, -3, -1, 1, 1, -3, -3, 3, 1, 1, -3],
    [1, 3, 3, 1, -1, -3, 3, -1, 3, 3, 3, -3, 1, -1, 1, -1, -3, -1, 1, 3, -1, 3, -3, -3],
    [-1, -3, 3, -3, -3, -3, -1, -1, -3, -1, -3, 3, 1, 3, -3, -1, 3, -1, 1, -1, 3, -3, 1, -1],
    [-3, -3, 1, 1, -1, 1, -1, 1, -1, 3, 1, -3, -1, 1, -1, 1, -1, -1, 3, 3, -3, -1, 1, -3],
    [-3, -1, -3, 3, 1, -1, -3, -1, -3, -3, 3, -3, 3, -3, -1, 1, 3, 1, -3, 1, 3, 3, -1, -3],
    [-1, -1, -1, -1, 3, 3, 3, 1, 3, 3, -3, 1, 3, -1, 3, -1, 3, 3, -3, 3, 1, -1, 3, 3],
    [1, -1, 3, 3, -1, -3, 3, -3, -1, -1, 3, -1, 3, -1, -1, 1, 1, 1, 1, -1, -1, -3, -1, 3],
    [1, -1, 1, -1, 3, -1, 3, 1, 1, -1, -1, -3, 1, 1, -3, 1, 3, -3, 1, 1, -3, -3, -1, -1],
    [-3, -1, 1, 3, 1, 1, -3, -1, -1, -3, 3, -3, 3, 1, -3, 3, -3, 1, -1, 1, -3, 1, 1, 1],
    [-1, -3, 3, 3, 1, 1, 3, -1, -3, -1, -1, -1, 3, 1, -3, -3, -1, 3, -3, -1, -3, -1, -3, -1],
    [-1, -3, -1, -1, 1, -3, -1, -1, 1, -1, -3, 1, 1, -3, 1, -3, -3, 3, 1, 1, -1, 3, -1, -1],
    [1, 1, -1, -1, -3, -1, 3, -1, 3, -1, 1, 3, 1, -1, 3, 1, 3, -3, -3, 1, -1, -1, 1, 3],
], np.float64)


@functools.lru_cache(maxsize=None)
def base_sequence(u: int, v: int, m_prb: int) -> np.ndarray:
    """r̄_u,v of length M = m_prb*12 (§5.5.1.1/§5.5.1.2)."""
    m = m_prb * NRE
    if m_prb == 1:
        return np.exp(1j * np.pi / 4 * _PHI_M12[u]).astype(np.complex64)
    if m_prb == 2:
        return np.exp(1j * np.pi / 4 * _PHI_M24[u]).astype(np.complex64)
    nzc = _largest_prime_below(m)
    qbar = nzc * (u + 1) / 31.0
    q = int(np.floor(qbar + 0.5)) + v * (-1) ** int(np.floor(2 * qbar))
    x = zadoff_chu(q, nzc)
    n = np.arange(m)
    return x[n % nzc].astype(np.complex64)


def shifted(u: int, v: int, m_prb: int, alpha: float) -> np.ndarray:
    n = np.arange(m_prb * NRE)
    return (base_sequence(u, v, m_prb) * np.exp(1j * alpha * n)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _n_pn_table(cell_id: int, delta_ss: int = 0) -> np.ndarray:
    """n_PN(ns) for ns = 0..19 (§5.5.2.1.1 cyclic-shift hopping)."""
    f_ss = (cell_id + delta_ss) % 30
    c = gold_sequence((cell_id // 30) * 32 + f_ss, 8 * 7 * 20)
    ns = np.arange(20)
    bits = c[8 * 7 * ns[:, None] + np.arange(8)[None, :]]
    return (bits << np.arange(8)).sum(axis=1).astype(np.int64)


def pusch_dmrs(cell: Cell, sf_idx: int, m_prb: int,
               n_dmrs1: int = 0, n_dmrs2: int = 0,
               delta_ss: int = 0) -> np.ndarray:
    """DMRS for both slots of a subframe: [2, m_prb*12] complex64.

    Group hopping and sequence hopping disabled (the reference's defaults);
    u = f_ss = (cell_id + delta_ss) mod 30, v = 0.
    """
    u = (cell.id + delta_ss) % 30
    npn = _n_pn_table(cell.id, delta_ss)
    rows = []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        n_cs = (n_dmrs1 + n_dmrs2 + int(npn[ns])) % 12
        alpha = 2 * np.pi * n_cs / 12
        rows.append(shifted(u, 0, m_prb, alpha))
    return np.stack(rows)


def dmrs_symbol(cell: Cell) -> int:
    """DMRS SC-FDMA symbol index within a slot (3 for normal CP, 2 for ext)."""
    return 3 if cell.cp.nsymb == 7 else 2
