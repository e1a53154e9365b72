"""NR DCI formats 0_0 and 1_0 (38.212 §7.3.1).

Reference behavior: lib/src/phy/phch/dci_nr.c (dci_nr_format_1_0_sizeof:779,
dci_nr_format_0_0_sizeof:110, pack/unpack; 0_0/1_0 size alignment per
38.212 §7.3.1.0 — 0_0 is padded or its RIV truncated to match 1_0).

C-RNTI field layout only (the fallback formats srsENB/srsUE actually use).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .ra_nr import NrGrant, riv_nr, riv_nr_decode


def _riv_bits(n_bwp: int) -> int:
    return int(math.ceil(math.log2(n_bwp * (n_bwp + 1) / 2)))


def dci_10_size(n_bwp: int) -> int:
    """C-RNTI format 1_0: id(1)+riv+time(4)+vrb(1)+mcs(5)+ndi(1)+rv(2)
    +harq(4)+dai(2)+tpc(2)+pucch(3)+timing(3)."""
    return 28 + _riv_bits(n_bwp)


def dci_00_size(n_bwp_ul: int, n_bwp_dl: int) -> int:
    """0_0 is size-aligned to 1_0 (38.212 §7.3.1.0)."""
    return dci_10_size(n_bwp_dl)


def _put(bits, pos, value, width):
    for i in range(width):
        bits[pos + i] = (int(value) >> (width - 1 - i)) & 1
    return pos + width


def _get(bits, pos, width):
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    return v, pos + width


@dataclass(frozen=True)
class Dci10:
    """DL fallback grant (C-RNTI)."""

    rb_start: int
    l_rb: int
    mcs: int
    time_ra: int = 0
    vrb_to_prb: int = 0
    ndi: int = 0
    rv: int = 0
    harq_pid: int = 0
    dai: int = 0
    tpc: int = 0
    pucch_ri: int = 0
    harq_timing: int = 0

    def grant(self, n_bwp: int) -> NrGrant:
        return NrGrant(self.rb_start, self.l_rb, self.mcs, rv=self.rv,
                       ndi=self.ndi, harq_pid=self.harq_pid)


def pack_dci_10(d: Dci10, n_bwp: int) -> np.ndarray:
    bits = np.zeros(dci_10_size(n_bwp), np.uint8)
    pos = _put(bits, 0, 1, 1)  # DCI format identifier: 1 = DL
    pos = _put(bits, pos, riv_nr(n_bwp, d.rb_start, d.l_rb), _riv_bits(n_bwp))
    pos = _put(bits, pos, d.time_ra, 4)
    pos = _put(bits, pos, d.vrb_to_prb, 1)
    pos = _put(bits, pos, d.mcs, 5)
    pos = _put(bits, pos, d.ndi, 1)
    pos = _put(bits, pos, d.rv, 2)
    pos = _put(bits, pos, d.harq_pid, 4)
    pos = _put(bits, pos, d.dai, 2)
    pos = _put(bits, pos, d.tpc, 2)
    pos = _put(bits, pos, d.pucch_ri, 3)
    _put(bits, pos, d.harq_timing, 3)
    return bits


def unpack_dci_10(bits: np.ndarray, n_bwp: int) -> Dci10 | None:
    pos = 0
    fmt, pos = _get(bits, pos, 1)
    if fmt != 1:
        return None  # it's a 0_0
    riv, pos = _get(bits, pos, _riv_bits(n_bwp))
    if riv >= n_bwp * (n_bwp + 1) // 2:
        return None
    time_ra, pos = _get(bits, pos, 4)
    vrb, pos = _get(bits, pos, 1)
    mcs, pos = _get(bits, pos, 5)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    harq, pos = _get(bits, pos, 4)
    dai, pos = _get(bits, pos, 2)
    tpc, pos = _get(bits, pos, 2)
    pucch_ri, pos = _get(bits, pos, 3)
    timing, pos = _get(bits, pos, 3)
    rb_start, l_rb = riv_nr_decode(n_bwp, riv)
    return Dci10(rb_start, l_rb, mcs, time_ra, vrb, ndi, rv, harq, dai, tpc,
                 pucch_ri, timing)


@dataclass(frozen=True)
class Dci00:
    """UL fallback grant (C-RNTI)."""

    rb_start: int
    l_rb: int
    mcs: int
    time_ra: int = 0
    hopping: int = 0
    ndi: int = 0
    rv: int = 0
    harq_pid: int = 0
    tpc: int = 0

    def grant(self, n_bwp: int) -> NrGrant:
        return NrGrant(self.rb_start, self.l_rb, self.mcs, rv=self.rv,
                       ndi=self.ndi, harq_pid=self.harq_pid)


def pack_dci_00(d: Dci00, n_bwp_ul: int, n_bwp_dl: int) -> np.ndarray:
    """Packs then zero-pads to the 1_0-aligned size."""
    bits = np.zeros(dci_00_size(n_bwp_ul, n_bwp_dl), np.uint8)
    pos = _put(bits, 0, 0, 1)  # DCI format identifier: 0 = UL
    pos = _put(bits, pos, riv_nr(n_bwp_ul, d.rb_start, d.l_rb),
               _riv_bits(n_bwp_ul))
    pos = _put(bits, pos, d.time_ra, 4)
    pos = _put(bits, pos, d.hopping, 1)
    pos = _put(bits, pos, d.mcs, 5)
    pos = _put(bits, pos, d.ndi, 1)
    pos = _put(bits, pos, d.rv, 2)
    pos = _put(bits, pos, d.harq_pid, 4)
    pos = _put(bits, pos, d.tpc, 2)
    assert pos <= len(bits), "0_0 larger than aligned size (truncation TBD)"
    return bits


def unpack_dci_00(bits: np.ndarray, n_bwp_ul: int) -> Dci00 | None:
    pos = 0
    fmt, pos = _get(bits, pos, 1)
    if fmt != 0:
        return None
    riv, pos = _get(bits, pos, _riv_bits(n_bwp_ul))
    if riv >= n_bwp_ul * (n_bwp_ul + 1) // 2:
        return None
    time_ra, pos = _get(bits, pos, 4)
    hop, pos = _get(bits, pos, 1)
    mcs, pos = _get(bits, pos, 5)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    harq, pos = _get(bits, pos, 4)
    tpc, pos = _get(bits, pos, 2)
    rb_start, l_rb = riv_nr_decode(n_bwp_ul, riv)
    return Dci00(rb_start, l_rb, mcs, time_ra, hop, ndi, rv, harq, tpc)
