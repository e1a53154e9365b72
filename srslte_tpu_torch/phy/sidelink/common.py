"""Sidelink TM1/2 subframe geometry + DMRS (36.211 §9, phy_common_sl.c).

Reference behavior: lib/src/phy/common/phy_common_sl.c symbol maps
(psbch_symbol_map_tm12:120), lib/src/phy/ch_estimation/chest_sl.c DMRS
parameter derivations (psbch:85, pscch:273, pssch grouping/f_gh).
Normal CP only (the TM1/2 default).

Host numpy, as in the JAX package: the channels upload these tables once
per device.  They are built here, not converted from the JAX package
(`convert.py` has nothing to carry for the sidelink).
"""

from __future__ import annotations

import numpy as np

from ..chest.refsignal_ul import base_sequence
from ..common.sequence import gold_sequence

NRE = 12
# TM1/2 sync subframe (PSBCH): 36.211 §9.8 table — symbol roles
PSBCH_DATA_SYMS = (0, 4, 5, 6, 7, 8, 9)  # 7 transmitted
PSBCH_E_SYMS = 8  # E spans one extra virtual symbol (psbch.c:57 "not tx'ed")
PSSS_SYMS = (1, 2)
SSSS_SYMS = (11, 12)
SL_DMRS_SYMS = (3, 10)  # PSBCH/PSCCH/PSSCH TM1/2 DMRS symbols
GUARD_SYM = 13
# PSCCH/PSSCH TM1/2: 11 transmitted data symbols, E spans 12
PSCCH_DATA_SYMS = tuple(l for l in range(13) if l not in SL_DMRS_SYMS)
PSSCH_DATA_SYMS = PSCCH_DATA_SYMS
SL_E_SYMS = 12


def sl_dmrs(u: int, n_cs: int, w1: int, n_prb: int) -> np.ndarray:
    """[2, n_prb*12] DMRS for the two TM1/2 DMRS symbols.

    r_uv with cyclic shift alpha = 2*pi*n_cs/12 and the length-2 OCC
    [1, w1] (chest_sl.c:121-128)."""
    alpha = 2 * np.pi * n_cs / NRE
    n = np.arange(n_prb * NRE)
    r = (base_sequence(u, 0, n_prb) * np.exp(1j * alpha * n)).astype(np.complex64)
    return np.stack([r, w1 * r])


def psbch_dmrs(n_sl_id: int) -> np.ndarray:
    """PSBCH DMRS over 6 PRB (chest_sl_psbch_gen:85)."""
    u = (n_sl_id // 16) % 30
    n_cs = (n_sl_id // 2) % 8
    w1 = -1 if n_sl_id % 2 else 1
    return sl_dmrs(u, n_cs, w1, 6)


def pscch_dmrs(cyclic_shift: int, n_prb: int = 1) -> np.ndarray:
    """PSCCH DMRS: u = 0 (TM1/2), configured cyclic shift in {0,3,6,9}
    (chest_sl_pscch_gen:273)."""
    return sl_dmrs(0, cyclic_shift, 1, n_prb)


def _f_gh_pattern(n_x_id: int, length: int = 20) -> np.ndarray:
    """Group-hopping pattern f_gh(ns) (36.211 §10.1.4.1.3, gold seeded by
    floor(N_x_id / 30))."""
    c = gold_sequence(n_x_id // 30, 8 * length)
    i = np.arange(8)
    return ((c.reshape(length, 8) << i).sum(-1) % 30).astype(np.int64)


def pssch_dmrs(n_x_id: int, n_prb: int) -> np.ndarray:
    """PSSCH TM1/2 DMRS (chest_sl_pssch_gen): per-symbol group number from
    the hopping pattern + f_ss = N_x_id mod 30."""
    n_cs = (n_x_id // 2) % 8
    w1 = -1 if n_x_id % 2 else 1
    f_gh = _f_gh_pattern(n_x_id)
    alpha = 2 * np.pi * n_cs / NRE
    n = np.arange(n_prb * NRE)
    rows = []
    for ns in range(2):
        u = int((f_gh[ns] + n_x_id % 30) % 30)
        r = (base_sequence(u, 0, n_prb)
             * np.exp(1j * alpha * n)).astype(np.complex64)
        rows.append(r * (w1 if ns else 1))
    return np.stack(rows)
