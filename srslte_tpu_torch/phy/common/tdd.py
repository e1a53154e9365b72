"""TDD frame structure type 2 tables and helpers (36.211 §4.2).

Reference behavior: lib/src/phy/common/phy_common.c: the UL/DL
configuration table (srsran_sfidx_tdd_type, table 4.2-2), the special
subframe DwPTS/GP/UpPTS symbol split (srsran_sfidx_tdd_nof_dw/gp/up,
table 4.2-1 as of v13), per-slot DwPTS symbol counts
(srsran_sfidx_tdd_nof_dw_slot), and the per-configuration DL HARQ process
count (srsran_tdd_nof_harq).

These are pure host-side lookups: the per-subframe grids keep their shape
(the full 14-symbol grid is always produced; TDD masks which symbols carry
DL vs UL energy), so nothing here reaches the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum

from .params import CP


class SfType(Enum):
    DL = "D"
    UL = "U"
    SPECIAL = "S"


_D, _U, _S = SfType.DL, SfType.UL, SfType.SPECIAL

# 36.211 table 4.2-2: UL/DL configurations 0-6 over the 10 subframes
UL_DL_CONFIGS = (
    (_D, _S, _U, _U, _U, _D, _S, _U, _U, _U),
    (_D, _S, _U, _U, _D, _D, _S, _U, _U, _D),
    (_D, _S, _U, _D, _D, _D, _S, _U, _D, _D),
    (_D, _S, _U, _U, _U, _D, _D, _D, _D, _D),
    (_D, _S, _U, _U, _D, _D, _D, _D, _D, _D),
    (_D, _S, _U, _D, _D, _D, _D, _D, _D, _D),
    (_D, _S, _U, _U, _U, _D, _S, _U, _U, _D),
)

# 36.211 table 4.2-1 (v13): special subframe config -> (DwPTS, GP, UpPTS)
# symbol counts, normal CP
SPECIAL_SF_SYMBOLS = (
    (3, 10, 1), (9, 4, 1), (10, 3, 1), (11, 2, 1), (12, 1, 1),
    (3, 9, 2), (9, 3, 2), (10, 2, 2), (11, 1, 1), (6, 6, 2),
)

# DL HARQ processes per UL/DL configuration (36.213 table 7-1 derived;
# phy_common.c tdd_nof_harq)
NOF_HARQ = (7, 4, 2, 3, 2, 1, 6)

# 36.213 table 8-2: UL grant delay k per (sf_config, DL/S subframe): a DCI0
# in subframe n schedules PUSCH in n+k; 0 = this subframe carries no UL
# grants (srsue phy_common.cc k_pusch)
K_PUSCH = (
    (4, 6, 0, 0, 0, 4, 6, 0, 0, 0),
    (0, 6, 0, 0, 4, 0, 6, 0, 0, 4),
    (0, 0, 0, 4, 0, 0, 0, 0, 4, 0),
    (4, 0, 0, 0, 0, 0, 0, 0, 4, 4),
    (0, 0, 0, 0, 0, 0, 0, 0, 4, 4),
    (0, 0, 0, 0, 0, 0, 0, 0, 4, 0),
    (7, 7, 0, 0, 0, 7, 7, 0, 0, 5),
)

# 36.213 table 9.1.2-1: PHICH delay k per (sf_config, UL subframe): the
# PHICH for a PUSCH in subframe n arrives in n+k (srsue phy_common.cc
# k_phich)
K_PHICH = (
    (0, 0, 4, 7, 6, 0, 0, 4, 7, 6),
    (0, 0, 4, 6, 0, 0, 0, 4, 6, 0),
    (0, 0, 6, 0, 0, 0, 0, 6, 0, 0),
    (0, 0, 6, 6, 6, 0, 0, 0, 0, 0),
    (0, 0, 6, 6, 0, 0, 0, 0, 0, 0),
    (0, 0, 6, 0, 0, 0, 0, 0, 0, 0),
    (0, 0, 4, 6, 6, 0, 0, 4, 7, 0),
)


@dataclass(frozen=True)
class TddConfig:
    """uplink-downlink-configuration + special-subframe-configuration."""

    sf_config: int = 0  # 0..6
    ss_config: int = 0  # 0..9

    def __post_init__(self):
        if not 0 <= self.sf_config <= 6:
            raise ValueError(f"invalid TDD sf_config {self.sf_config}")
        if not 0 <= self.ss_config <= 9:
            raise ValueError(f"invalid TDD ss_config {self.ss_config}")

    def sf_type(self, sf_idx: int) -> SfType:
        return UL_DL_CONFIGS[self.sf_config][sf_idx % 10]

    @property
    def nof_dw(self) -> int:
        """DwPTS symbols in a special subframe."""
        return SPECIAL_SF_SYMBOLS[self.ss_config][0]

    @property
    def nof_gp(self) -> int:
        return SPECIAL_SF_SYMBOLS[self.ss_config][1]

    @property
    def nof_up(self) -> int:
        return SPECIAL_SF_SYMBOLS[self.ss_config][2]

    def nof_dw_slot(self, slot: int, cp: CP = CP.NORM) -> int:
        """DwPTS symbols falling in slot 0 or 1 of the special subframe."""
        n = self.nof_dw
        nsym = cp.nsymb
        if n < nsym:
            return n if slot == 0 else 0
        return nsym if slot == 0 else n - nsym

    @property
    def nof_harq(self) -> int:
        return NOF_HARQ[self.sf_config]

    def dl_subframes(self) -> tuple[int, ...]:
        """Subframe indices usable for PDSCH (DL + special w/ DwPTS >= 9)."""
        out = []
        for i in range(10):
            t = self.sf_type(i)
            if t is SfType.DL or (t is SfType.SPECIAL and self.nof_dw >= 9):
                out.append(i)
        return tuple(out)

    def ul_subframes(self) -> tuple[int, ...]:
        return tuple(i for i in range(10) if self.sf_type(i) is SfType.UL)

    def k_pusch(self, sf_idx: int) -> int:
        """UL grant delay for a DCI0 in this subframe (0 = none here)."""
        return K_PUSCH[self.sf_config][sf_idx % 10]

    def k_phich(self, sf_idx: int) -> int:
        """PHICH delay for a PUSCH in this subframe (0 = n/a)."""
        return K_PHICH[self.sf_config][sf_idx % 10]

    def next_ul(self, tti: int) -> int:
        """First UL subframe at or after tti (RAR-grant/msg3 timing)."""
        for d in range(10):
            if self.sf_type((tti + d) % 10) is SfType.UL:
                return tti + d
        raise ValueError("configuration has no UL subframes")

    def sr_subframes(self) -> tuple[int, ...]:
        """SR opportunity subframes: UL subframes on the apps' period-5
        comb where possible (the FDD convention tti%5==3), else every UL
        subframe (configs whose UL subframes all miss the comb)."""
        ul = self.ul_subframes()
        combed = tuple(i for i in ul if i % 5 == 3)
        return combed or ul
