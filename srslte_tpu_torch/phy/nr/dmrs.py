"""NR SCH DMRS, configuration types 1 and 2, additional positions
(38.211 §7.4.1.1, dmrs_sch.c).

Reference behavior: lib/src/phy/ch_estimation/dmrs_sch.c — Gold sequence
c_init = (2^17 (14 n_slot + l + 1)(2 N_ID + 1) + 2 N_ID) mod 2^31 per DMRS
symbol; type 1 places 6 pilots/PRB on the comb (k = 4n + 2k' + delta),
type 2 places 4 pilots/PRB in subcarrier pairs (k = 6n + k' + delta);
mapping type A single-symbol DMRS at l0 = 2 with dmrs-AdditionalPosition
adding symbols per table 7.4.1.1.2-3.
"""

from __future__ import annotations

import functools

import numpy as np

from ..common.sequence import gold_sequence
from .params import NrCarrier

# 38.211 table 7.4.1.1.2-3 (mapping type A, l_d = 14, l0 = 2)
_ADD_POS_SYMS = {0: (2,), 1: (2, 11), 2: (2, 7, 11), 3: (2, 5, 8, 11)}


def dmrs_symbols(add_pos: int = 0) -> tuple[int, ...]:
    return _ADD_POS_SYMS[add_pos]


def dmrs_cinit(slot: int, l: int, n_id: int) -> int:
    return ((1 << 17) * (14 * slot + l + 1) * (2 * n_id + 1)
            + 2 * n_id) % (1 << 31)


@functools.lru_cache(maxsize=None)
def dmrs_values(carrier: NrCarrier, slot: int, l: int,
                cfg_type: int = 1) -> np.ndarray:
    """Pilot values in mapping order: [6*n_prb] (type 1) / [4*n_prb]."""
    per_prb = 6 if cfg_type == 1 else 4
    c = gold_sequence(dmrs_cinit(slot, l, carrier.n_id),
                      2 * per_prb * carrier.n_prb).astype(np.float32)
    vals = (1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])
    return (vals / np.sqrt(2)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def dmrs_subcarriers(carrier: NrCarrier, cfg_type: int = 1,
                     delta: int = 0) -> np.ndarray:
    """Pilot subcarriers, same order as dmrs_values.

    Type 1 (comb-2, CDM group delta in {0,1}): k = 4n + 2k' + delta.
    Type 2 (pairs, delta in {0,1,2}):          k = 6n + k' + 2*delta.
    """
    if cfg_type == 1:
        return (2 * np.arange(6 * carrier.n_prb) + delta).astype(np.int32)
    n = np.arange(2 * carrier.n_prb)  # pair index
    base = 6 * n + 2 * delta
    return np.stack([base, base + 1], -1).reshape(-1).astype(np.int32)
