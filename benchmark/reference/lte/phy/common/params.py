# Frozen copy of srslte_tpu_torch/phy/common/params.py at commit e4337f4, unchanged but for this line.
"""LTE numerology: PRB/FFT-size/CP math.

Reference semantics: srsRAN lib/src/phy/common/phy_common.c:361-455
(srsran_symbol_sz), lib/include/srsran/phy/common/phy_common.h:123-158 (CP/slot
length macros).  All quantities here are static Python ints: they define the
shape buckets whose index tables are built once and cached per device.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, replace

NRE = 12  # subcarriers per PRB (phy_common.h SRSRAN_NRE)
NOF_SLOTS_PER_SF = 2
NOF_SF_X_FRAME = 10

# PRB count -> DFT size (phy_common.c:361-455, standard LTE symbol sizes)
_SYMBOL_SZ = {6: 128, 15: 256, 25: 512, 50: 1024, 75: 1536, 100: 2048}

# CP lengths are specified in units of Ts = 1/(15000*2048) s (36.211 §6.12)
_CP_NORM_0_LEN = 160
_CP_NORM_LEN = 144
_CP_EXT_LEN = 512


class CP(enum.Enum):
    NORM = "norm"  # 7 symbols/slot
    EXT = "ext"  # 6 symbols/slot

    @property
    def nsymb(self) -> int:
        return 7 if self is CP.NORM else 6


def symbol_sz(n_prb: int) -> int:
    """DFT size for a PRB count (phy_common.c:361)."""
    if n_prb in _SYMBOL_SZ:
        return _SYMBOL_SZ[n_prb]
    raise ValueError(f"unsupported nof_prb={n_prb} (supported: {sorted(_SYMBOL_SZ)})")


def nof_prb(sz: int) -> int:
    for p, s in _SYMBOL_SZ.items():
        if s == sz:
            return p
    raise ValueError(f"no PRB count for symbol_sz={sz}")


def sampling_freq_hz(n_prb: int) -> int:
    """15 kHz subcarrier spacing × DFT size (phy_common.c:332-339)."""
    return 15000 * symbol_sz(n_prb)


def cp_len(sz: int, cp_ts: int) -> int:
    """SRSRAN_CP_LEN: ceil(c * N / 2048) samples (phy_common.h:125)."""
    return math.ceil(cp_ts * sz / 2048)


def cp_len_norm(symbol_idx: int, sz: int) -> int:
    return cp_len(sz, _CP_NORM_0_LEN if symbol_idx == 0 else _CP_NORM_LEN)


def cp_len_ext(sz: int) -> int:
    return cp_len(sz, _CP_EXT_LEN)


@dataclass(frozen=True)
class OfdmParams:
    """Static OFDM numerology for one bandwidth bucket."""

    n_prb: int
    cp: CP = CP.NORM

    @property
    def symbol_sz(self) -> int:
        return symbol_sz(self.n_prb)

    @property
    def nof_re(self) -> int:
        return self.n_prb * NRE

    @property
    def nof_guards(self) -> int:
        return (self.symbol_sz - self.nof_re) // 2

    @property
    def nsymb_slot(self) -> int:
        return self.cp.nsymb

    @property
    def nsymb_sf(self) -> int:
        return 2 * self.cp.nsymb

    @property
    def slot_len(self) -> int:
        return self.symbol_sz * 15 // 2

    @property
    def sf_len(self) -> int:
        return self.symbol_sz * 15

    @property
    def srate(self) -> int:
        return 15000 * self.symbol_sz

    def cp_lens_slot(self) -> tuple[int, ...]:
        """CP length of each symbol in one slot."""
        if self.cp is CP.NORM:
            return tuple(cp_len_norm(i, self.symbol_sz) for i in range(7))
        return tuple(cp_len_ext(self.symbol_sz) for _ in range(6))

    def symbol_offsets_slot(self) -> tuple[int, ...]:
        """Sample offset of the start (incl. CP) of each symbol within a slot."""
        offs, acc = [], 0
        for c in self.cp_lens_slot():
            offs.append(acc)
            acc += c + self.symbol_sz
        assert acc == self.slot_len
        return tuple(offs)


@dataclass(frozen=True)
class Cell:
    """LTE cell definition (srsran_cell_t, phy_common.h:181-197)."""

    n_prb: int = 6
    nof_ports: int = 1
    id: int = 0  # PCI, 0..503
    cp: CP = CP.NORM
    phich_length: str = "norm"  # norm | ext
    phich_resources: str = "1"  # 1/6 | 1/2 | 1 | 2
    frame_type: str = "fdd"

    def __post_init__(self):
        if not (0 <= self.id < 504):
            raise ValueError(f"invalid cell id {self.id}")
        if self.nof_ports not in (1, 2, 4):
            raise ValueError(f"invalid nof_ports {self.nof_ports}")
        symbol_sz(self.n_prb)  # validate

    @property
    def ofdm(self) -> OfdmParams:
        return OfdmParams(self.n_prb, self.cp)

    @property
    def n_id_1(self) -> int:
        return self.id // 3

    @property
    def n_id_2(self) -> int:
        return self.id % 3

    @property
    def nof_re_sf(self) -> int:
        """REs in one subframe grid (all symbols × all subcarriers)."""
        o = self.ofdm
        return o.nsymb_sf * o.nof_re

    def with_prb(self, n_prb: int) -> "Cell":
        return replace(self, n_prb=n_prb)
