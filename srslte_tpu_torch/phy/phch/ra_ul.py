"""UL resource allocation & MCS math (36.213 §8.6, ra_ul.c equivalent).

Reference behavior: lib/src/phy/phch/ra_ul.c and tbs_tables.h: UL MCS 0-10 ->
QPSK (I_TBS = MCS), 11-20 -> 16QAM (I_TBS = MCS-1), 21-28 -> 64QAM
(I_TBS = MCS-2); TBS from the shared table.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..modem.modem import Modulation
from ._tbs_data import TBS_TABLE
from .dft_precoding import valid_prb


def ul_mcs_modulation(mcs: int) -> Modulation:
    if mcs <= 10:
        return Modulation.QPSK
    if mcs <= 20:
        return Modulation.QAM16
    if mcs <= 28:
        return Modulation.QAM64
    raise ValueError(f"reserved UL MCS {mcs}")


def ul_mcs_itbs(mcs: int) -> int:
    if mcs <= 10:
        return mcs
    if mcs <= 20:
        return mcs - 1
    return mcs - 2


def ul_tbs(mcs: int, n_prb: int) -> int:
    return TBS_TABLE[ul_mcs_itbs(mcs)][n_prb - 1]


@dataclass(frozen=True)
class UlGrant:
    """Contiguous PUSCH allocation (type-2, single cluster)."""

    prb_start: int
    n_prb: int
    mcs: int
    rv: int = 0

    def __post_init__(self):
        if not valid_prb(self.n_prb):
            raise ValueError(f"n_prb={self.n_prb} invalid for DFT precoding "
                             "(prime factors must be 2/3/5)")

    @property
    def modulation(self) -> Modulation:
        return ul_mcs_modulation(self.mcs)

    @property
    def tbs(self) -> int:
        return ul_tbs(self.mcs, self.n_prb)
