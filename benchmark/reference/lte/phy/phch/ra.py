# Frozen copy of srslte_tpu_torch/phy/phch/ra.py at commit e4337f4, unchanged but for this line.
"""DL resource allocation & MCS/TBS math (36.213 §7.1.7, ra_dl.c equivalent).

Reference behavior: lib/src/phy/phch/{ra.c, ra_dl.c}; TBS data in
_tbs_data.py (standard ETSI table, same data as tbs_tables.h).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from ..modem.modem import Modulation
from ._tbs_data import TBS_TABLE

# 36.213 table 7.1.7.1-1: MCS -> I_TBS (tbs_tables.h dl_mcs_tbs_idx_table)
DL_MCS_TO_ITBS = [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 10, 11, 12, 13,
                  14, 15, 15, 16, 17, 18, 19, 20, 21, 22, 23, 24, 25, 26]


def dl_mcs_modulation(mcs: int) -> Modulation:
    if mcs <= 9:
        return Modulation.QPSK
    if mcs <= 16:
        return Modulation.QAM16
    if mcs <= 28:
        return Modulation.QAM64
    raise ValueError(f"reserved/unsupported DL MCS {mcs}")


def dl_tbs(mcs: int, n_prb: int) -> int:
    """Transport block size in bits for MCS + allocated PRB count."""
    if not 1 <= n_prb <= 110:
        raise ValueError(f"invalid n_prb {n_prb}")
    return TBS_TABLE[DL_MCS_TO_ITBS[mcs]][n_prb - 1]


def tbs_from_itbs(i_tbs: int, n_prb: int) -> int:
    return TBS_TABLE[i_tbs][n_prb - 1]


# 36.213 table 7.1.7.2.3-1: TBS for DCI format 1C (ra_dl.c tbs_format1c_table)
TBS_FORMAT1C = [40, 56, 72, 120, 136, 144, 176, 208, 224, 256, 280,
                296, 328, 336, 392, 488, 552, 600, 632, 696, 776,
                840, 904, 1000, 1064, 1128, 1224, 1288, 1384, 1480,
                1608, 1736]


@dataclass(frozen=True)
class DlGrant:
    """A downlink allocation: PRB mask + MCS (single transport block, TM1/TM2)."""

    prb_mask: tuple[bool, ...]  # length cell.n_prb (slot 0 for distributed VRB)
    mcs: int
    rv: int = 0
    # For P/SI/RA-RNTI format-1A grants the TBS is looked up with
    # N_prb_1A in {2,3} (from the TPC LSB) and modulation is QPSK,
    # independent of the allocated PRB count (ra_dl.c:374-381).
    tbs_override: int | None = None
    mod_override: Modulation | None = None
    # Distributed VRB (36.211 §6.2.3.2): odd-numbered slot uses a different
    # PRB set (slot hopping).  None = same mask both slots (localized).
    prb_mask_slot1: tuple[bool, ...] | None = None
    # TDD DwPTS grant: TBS looked up with max(1, 0.75 * n_prb)
    # (36.213 §7.1.7, ra_dl.c:402-403)
    is_dwpts: bool = False

    @property
    def n_prb(self) -> int:
        return int(sum(self.prb_mask))

    @property
    def modulation(self) -> Modulation:
        if self.mod_override is not None:
            return self.mod_override
        return dl_mcs_modulation(self.mcs)

    @property
    def tbs(self) -> int:
        if self.tbs_override is not None:
            return self.tbs_override
        n_prb = self.n_prb
        if self.is_dwpts:
            n_prb = max(1, int(0.75 * n_prb))
        return dl_tbs(self.mcs, n_prb)

    @staticmethod
    def full(cell_n_prb: int, mcs: int, rv: int = 0) -> "DlGrant":
        return DlGrant(tuple([True] * cell_n_prb), mcs, rv)

    @staticmethod
    def type0(cell_n_prb: int, rbg_bitmask: int, mcs: int, rv: int = 0) -> "DlGrant":
        """RA type 0: bitmap over RBGs (36.213 §7.1.6.1), MSB = RBG 0."""
        p = rbg_size(cell_n_prb)
        n_rbg = -(-cell_n_prb // p)
        mask = np.zeros(cell_n_prb, bool)
        for g in range(n_rbg):
            if (rbg_bitmask >> (n_rbg - 1 - g)) & 1:
                mask[g * p : min((g + 1) * p, cell_n_prb)] = True
        return DlGrant(tuple(mask.tolist()), mcs, rv)

    @staticmethod
    def type2(cell_n_prb: int, rb_start: int, l_crb: int, mcs: int, rv: int = 0) -> "DlGrant":
        """RA type 2 (contiguous, DCI 1A; 36.213 §7.1.6.3)."""
        mask = np.zeros(cell_n_prb, bool)
        mask[rb_start : rb_start + l_crb] = True
        return DlGrant(tuple(mask.tolist()), mcs, rv)

    @staticmethod
    def type1(cell_n_prb: int, rbg_subset: int, shift: bool, vrb_bitmask: int,
              mcs: int, rv: int = 0) -> "DlGrant":
        """RA type 1 (36.213 §7.1.6.2): VRB bitmap within one RBG subset.

        `vrb_bitmask` has type1_nbits(cell_n_prb) bits, MSB first, addressing
        the subset's PRBs with an optional shift (ra.c srsran_ra_type1_N_rbg).
        """
        p = rbg_size(cell_n_prb)
        nb = type1_nbits(cell_n_prb)
        # PRBs belonging to subset p_sel, in increasing order (36.213 §7.1.6.2)
        prbs = [n for n in range(cell_n_prb) if (n // p) % p == rbg_subset]
        # shift moves the addressing window to the tail of the subset
        offset = max(0, len(prbs) - nb) if shift else 0
        mask = np.zeros(cell_n_prb, bool)
        for i in range(nb):
            j = i + offset
            if j < len(prbs) and (vrb_bitmask >> (nb - 1 - i)) & 1:
                mask[prbs[j]] = True
        return DlGrant(tuple(mask.tolist()), mcs, rv)

    @staticmethod
    def type2_dist(cell_n_prb: int, rb_start: int, l_crb: int, mcs: int,
                   rv: int = 0, ngap_is_1: bool = True) -> "DlGrant":
        """RA type 2 distributed VRB (36.211 §6.2.3.2): per-slot PRB masks."""
        m0, m1 = dist_vrb_to_prb(cell_n_prb, rb_start, l_crb, ngap_is_1)
        return DlGrant(tuple(m0.tolist()), mcs, rv,
                       prb_mask_slot1=tuple(m1.tolist()))


def type1_nbits(cell_n_prb: int) -> int:
    """N_RB^type1 bitmap width (36.213 §7.1.6.2, ra.c srsran_ra_type1_N_rb)."""
    p = rbg_size(cell_n_prb)
    return -(-cell_n_prb // p) - math.ceil(math.log2(p)) - 1


def type2_ngap(cell_n_prb: int, ngap_is_1: bool = True) -> int:
    """N_gap for distributed VRB (36.211 table 6.2.3.2-1, ra.c:81)."""
    if cell_n_prb <= 10:
        return cell_n_prb // 2
    if cell_n_prb == 11:
        return 4
    if cell_n_prb <= 19:
        return 8
    if cell_n_prb <= 26:
        return 12
    if cell_n_prb <= 44:
        return 18
    if cell_n_prb <= 49:
        return 27
    if cell_n_prb <= 63:
        return 27 if ngap_is_1 else 9
    if cell_n_prb <= 79:
        return 32 if ngap_is_1 else 16
    return 48 if ngap_is_1 else 16


def type2_n_rb_step(cell_n_prb: int) -> int:
    """RB step for DCI 1C allocations (36.213 §7.1.6.3, ra.c:105)."""
    return 2 if cell_n_prb < 50 else 4


def type2_n_vrb_dl(cell_n_prb: int, ngap_is_1: bool = True) -> int:
    """Number of distributed VRBs (36.211 §6.2.3.2, ra.c:115)."""
    ngap = type2_ngap(cell_n_prb, ngap_is_1)
    if ngap_is_1:
        return 2 * min(ngap, cell_n_prb - ngap)
    return (cell_n_prb // ngap) * 2 * ngap


def dist_vrb_to_prb(cell_n_prb: int, rb_start: int, l_crb: int,
                    ngap_is_1: bool = True) -> tuple[np.ndarray, np.ndarray]:
    """Distributed VRB -> per-slot PRB masks (36.211 §6.2.3.2, ra_dl.c:255-315).

    Block-interleaves VRB numbers over rows of a (N_row x 4) matrix with
    N_null padding, then offsets the second half by N_gap; the even slot uses
    the interleaved index, the odd slot the same cyclically shifted by
    N_tilde_vrb/2 (slot hopping).
    """
    p = rbg_size(cell_n_prb)
    if ngap_is_1:
        n_tilde_vrb = type2_n_vrb_dl(cell_n_prb, True)
        n_gap = type2_ngap(cell_n_prb, True)
    else:
        n_tilde_vrb = 2 * type2_ngap(cell_n_prb, False)
        n_gap = type2_ngap(cell_n_prb, False)
    n_row = -(-n_tilde_vrb // (4 * p)) * p
    n_null = 4 * n_row - n_tilde_vrb
    m0 = np.zeros(cell_n_prb, bool)
    m1 = np.zeros(cell_n_prb, bool)
    for i in range(l_crb):
        n_vrb = i + rb_start
        nt = n_vrb % n_tilde_vrb
        base = n_tilde_vrb * (n_vrb // n_tilde_vrb)
        n_tilde_prb = 2 * n_row * (nt % 2) + nt // 2 + base
        n_tilde2_prb = n_row * (nt % 4) + nt // 4 + base
        if n_null and nt >= n_tilde_vrb - n_null and nt % 2 == 1:
            odd = n_tilde_prb - n_row
        elif n_null and nt >= n_tilde_vrb - n_null and nt % 2 == 0:
            odd = n_tilde_prb - n_row + n_null // 2
        elif n_null and nt < n_tilde_vrb - n_null and nt % 4 >= 2:
            odd = n_tilde2_prb - n_null // 2
        else:
            odd = n_tilde2_prb
        even = (odd + n_tilde_vrb // 2) % n_tilde_vrb + base
        for mask, idx in ((m0, odd), (m1, even)):
            prb = idx if idx < n_tilde_vrb // 2 else idx + n_gap - n_tilde_vrb // 2
            if prb >= cell_n_prb:
                raise ValueError("distributed VRB allocation exceeds bandwidth")
            mask[prb] = True
    return m0, m1


def rbg_size(cell_n_prb: int) -> int:
    """RBG size P per bandwidth (36.213 table 7.1.6.1-1)."""
    if cell_n_prb <= 10:
        return 1
    if cell_n_prb <= 26:
        return 2
    if cell_n_prb <= 63:
        return 3
    return 4


def riv_type2(cell_n_prb: int, rb_start: int, l_crb: int) -> int:
    """Resource indication value for DCI 1A (36.213 §7.1.6.3, ra.c)."""
    if l_crb < 1 or rb_start + l_crb > cell_n_prb:
        raise ValueError("invalid type2 allocation")
    if (l_crb - 1) <= cell_n_prb // 2:
        return cell_n_prb * (l_crb - 1) + rb_start
    return cell_n_prb * (cell_n_prb - l_crb + 1) + (cell_n_prb - 1 - rb_start)


def riv_type2_decode(cell_n_prb: int, riv: int) -> tuple[int, int]:
    l_crb = riv // cell_n_prb + 1
    rb_start = riv % cell_n_prb
    if rb_start + l_crb > cell_n_prb:
        l_crb = cell_n_prb - l_crb + 2
        rb_start = cell_n_prb - 1 - rb_start
    return rb_start, l_crb
