# Frozen copy of srslte_tpu_torch/phy/phch/dci.py at commit e4337f4, unchanged but for this line.
"""DCI pack/unpack, formats 0/1/1A/1B/1C/1D/2/2A/2B (36.212 §5.3.3.1).

Reference behavior: lib/src/phy/phch/dci.c (dci_format*_pack/unpack and the
*_sizeof functions: ambiguous-size table, format0/1A equalization, 1B pad-up
to raw format0, per-format precoding-information widths).

All host-side numpy: DCI payloads are control-plane data assembled on the
host; the device only sees the coded bit tensors (pdcch.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .ra import (DlGrant, rbg_size, riv_type2, riv_type2_decode, type1_nbits,
                 type2_n_rb_step, type2_n_vrb_dl)

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE
M_RNTI = 0xFFFD


def rnti_is_common(rnti: int) -> bool:
    """P/SI/RA-RNTI (not a UE C-RNTI): SRSRAN_RNTI_ISUSER inverse."""
    return rnti in (SI_RNTI, P_RNTI) or 1 <= rnti <= 0x3C

# 36.212 table 5.3.3.1.2-1: payload sizes needing one disambiguation pad bit
AMBIGUOUS_SIZES = {12, 14, 16, 20, 24, 26, 32, 40, 44, 56}


def _put(bits, pos, value, width):
    for i in range(width):
        bits[pos + i] = (value >> (width - 1 - i)) & 1
    return pos + width


def _get(bits, pos, width):
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    return v, pos + width


def riv_nbits(n_prb: int) -> int:
    return int(math.ceil(math.log2(n_prb * (n_prb + 1) / 2)))


def format0_1a_size(n_prb: int) -> int:
    """Common size of formats 0 and 1A after equalization + disambiguation."""
    f1a = 15 + riv_nbits(n_prb)  # flag+vrb+riv+mcs(5)+harq(3)+ndi+rv(2)+tpc(2)
    f0 = 14 + riv_nbits(n_prb)  # flag+hop+riv+mcs(5)+ndi+tpc(2)+dmrs(3)+cqi(1)
    sz = max(f1a, f0)
    while sz in AMBIGUOUS_SIZES:
        sz += 1
    return sz


def format1_size(n_prb: int) -> int:
    n_rbg = -(-n_prb // rbg_size(n_prb))
    sz = (1 if n_prb > 10 else 0) + n_rbg + 13  # hdr+bitmap+mcs5+harq3+ndi+rv2+tpc2
    if sz == format0_1a_size(n_prb):
        sz += 1
    while sz in AMBIGUOUS_SIZES:
        sz += 1
    return sz


@dataclass(frozen=True)
class Dci1A:
    """Compact DL grant (type-2 localized allocation)."""

    rb_start: int
    l_crb: int
    mcs: int
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0

    def grant(self, n_prb: int, rnti: int | None = None) -> DlGrant:
        if rnti is not None and rnti_is_common(rnti):
            # P/SI/RA-RNTI: mcs field is I_TBS directly, QPSK, and the TBS
            # row is N_prb_1A = 2 or 3 chosen by the TPC LSB (ra_dl.c:374-385).
            import dataclasses

            from ..modem.modem import Modulation
            from .ra import tbs_from_itbs

            n_prb_1a = 3 if (self.tpc & 1) else 2
            return dataclasses.replace(
                DlGrant.type2(n_prb, self.rb_start, self.l_crb, self.mcs, self.rv),
                tbs_override=tbs_from_itbs(self.mcs, n_prb_1a),
                mod_override=Modulation.QPSK,
            )
        return DlGrant.type2(n_prb, self.rb_start, self.l_crb, self.mcs, self.rv)


def pack_format1a(d: Dci1A, n_prb: int) -> np.ndarray:
    bits = np.zeros(format0_1a_size(n_prb), np.uint8)
    pos = _put(bits, 0, 1, 1)  # flag: 1 = format 1A
    pos = _put(bits, pos, 0, 1)  # localized VRB
    pos = _put(bits, pos, riv_type2(n_prb, d.rb_start, d.l_crb), riv_nbits(n_prb))
    pos = _put(bits, pos, d.mcs, 5)
    pos = _put(bits, pos, d.harq_pid, 3)
    pos = _put(bits, pos, d.ndi, 1)
    pos = _put(bits, pos, d.rv, 2)
    _put(bits, pos, d.tpc, 2)
    return bits


def unpack_format1a(bits: np.ndarray, n_prb: int) -> Dci1A | None:
    pos = 0
    flag, pos = _get(bits, pos, 1)
    if flag != 1:
        return None  # it's a format 0
    _, pos = _get(bits, pos, 1)
    riv, pos = _get(bits, pos, riv_nbits(n_prb))
    mcs, pos = _get(bits, pos, 5)
    harq, pos = _get(bits, pos, 3)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    tpc, pos = _get(bits, pos, 2)
    max_riv = n_prb * (n_prb + 1) // 2
    if riv >= max_riv:
        return None
    rb_start, l_crb = riv_type2_decode(n_prb, riv)
    return Dci1A(rb_start, l_crb, mcs, harq, ndi, rv, tpc)


@dataclass(frozen=True)
class Dci0:
    """UL grant (type-2 contiguous allocation on PUSCH)."""

    rb_start: int
    l_crb: int
    mcs_rv: int  # 5-bit joint MCS/RV index (36.213 §8.6)
    ndi: int = 0
    tpc: int = 0
    dmrs_cshift: int = 0
    cqi_request: int = 0
    hopping: int = 0


def pack_format0(d: Dci0, n_prb: int) -> np.ndarray:
    bits = np.zeros(format0_1a_size(n_prb), np.uint8)
    pos = _put(bits, 0, 0, 1)  # flag: 0 = format 0
    pos = _put(bits, pos, d.hopping, 1)
    pos = _put(bits, pos, riv_type2(n_prb, d.rb_start, d.l_crb), riv_nbits(n_prb))
    pos = _put(bits, pos, d.mcs_rv, 5)
    pos = _put(bits, pos, d.ndi, 1)
    pos = _put(bits, pos, d.tpc, 2)
    pos = _put(bits, pos, d.dmrs_cshift, 3)
    _put(bits, pos, d.cqi_request, 1)
    return bits


def unpack_format0(bits: np.ndarray, n_prb: int) -> Dci0 | None:
    pos = 0
    flag, pos = _get(bits, pos, 1)
    if flag != 0:
        return None
    hop, pos = _get(bits, pos, 1)
    riv, pos = _get(bits, pos, riv_nbits(n_prb))
    mcs_rv, pos = _get(bits, pos, 5)
    ndi, pos = _get(bits, pos, 1)
    tpc, pos = _get(bits, pos, 2)
    dmrs, pos = _get(bits, pos, 3)
    cqi, pos = _get(bits, pos, 1)
    if riv >= n_prb * (n_prb + 1) // 2:
        return None
    rb_start, l_crb = riv_type2_decode(n_prb, riv)
    return Dci0(rb_start, l_crb, mcs_rv, ndi, tpc, dmrs, cqi, hop)


@dataclass(frozen=True)
class Dci1:
    """Standard DL grant (RA type 0 RBG bitmap)."""

    rbg_bitmask: int
    mcs: int
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0

    def grant(self, n_prb: int, rnti: int | None = None) -> DlGrant:
        # format 1 is only ever CRC-scrambled by a C-RNTI; rnti accepted for
        # signature parity with Dci1A.grant
        return DlGrant.type0(n_prb, self.rbg_bitmask, self.mcs, self.rv)


def pack_format1(d: Dci1, n_prb: int) -> np.ndarray:
    bits = np.zeros(format1_size(n_prb), np.uint8)
    pos = 0
    if n_prb > 10:
        pos = _put(bits, pos, 0, 1)  # RA type 0
    n_rbg = -(-n_prb // rbg_size(n_prb))
    pos = _put(bits, pos, d.rbg_bitmask, n_rbg)
    pos = _put(bits, pos, d.mcs, 5)
    pos = _put(bits, pos, d.harq_pid, 3)
    pos = _put(bits, pos, d.ndi, 1)
    pos = _put(bits, pos, d.rv, 2)
    _put(bits, pos, d.tpc, 2)
    return bits


def unpack_format1(bits: np.ndarray, n_prb: int) -> Dci1 | None:
    pos = 0
    if n_prb > 10:
        ra_type, pos = _get(bits, pos, 1)
        if ra_type != 0:
            return None  # RA type 1 not supported yet
    n_rbg = -(-n_prb // rbg_size(n_prb))
    bitmask, pos = _get(bits, pos, n_rbg)
    mcs, pos = _get(bits, pos, 5)
    harq, pos = _get(bits, pos, 3)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    tpc, pos = _get(bits, pos, 2)
    return Dci1(bitmask, mcs, harq, ndi, rv, tpc)


# ---------------------------------------------------------------------------
# Formats 1B / 1C / 1D (compact type-2 grants) and 2 / 2A / 2B (dual TB).
# Reference: dci_format1B_unpack (dci.c:884), dci_format1Cs_pack (:937),
# dci_format1D_unpack (:1010), dci_format2AB_pack/unpack (:1061/:1138),
# sizes dci_format{1B,1C,1D,2,2A,2B}_sizeof (dci.c:227-356).
# ---------------------------------------------------------------------------

def tpmi_bits(n_ports: int) -> int:
    """TPMI width for 1B/1D (36.212 table 5.3.3.1.3A-1)."""
    return 2 if n_ports <= 2 else 4


def precoding_bits_f2(n_ports: int) -> int:
    return 3 if n_ports <= 2 else 6


def precoding_bits_f2a(n_ports: int) -> int:
    return 0 if n_ports <= 2 else 2


def _format0_raw_size(n_prb: int) -> int:
    """Format 0 before 1A equalization: dci_format0_sizeof_ (dci.c:185)."""
    return 14 + riv_nbits(n_prb)


def format1b_size(n_prb: int, n_ports: int) -> int:
    n = 1 + riv_nbits(n_prb) + 5 + 3 + 1 + 2 + 2 + tpmi_bits(n_ports) + 1
    n = max(n, _format0_raw_size(n_prb))
    while n in AMBIGUOUS_SIZES:
        n += 1
    return n


def format1d_size(n_prb: int, n_ports: int) -> int:
    return format1b_size(n_prb, n_ports)


def format1c_size(n_prb: int) -> int:
    n_vrb = type2_n_vrb_dl(n_prb, True)
    n = riv_nbits(n_vrb // type2_n_rb_step(n_prb)) + 5
    if n_prb >= 50:
        n += 1
    return n


def _format2x_size(n_prb: int, pbits: int) -> int:
    n_rbg = -(-n_prb // rbg_size(n_prb))
    n = n_rbg + 2 + 3 + 1 + 2 * (5 + 1 + 2) + pbits
    if n_prb > 10:
        n += 1
    while n in AMBIGUOUS_SIZES:
        n += 1
    return n


def format2_size(n_prb: int, n_ports: int) -> int:
    return _format2x_size(n_prb, precoding_bits_f2(n_ports))


def format2a_size(n_prb: int, n_ports: int) -> int:
    return _format2x_size(n_prb, precoding_bits_f2a(n_ports))


def format2b_size(n_prb: int, n_ports: int) -> int:
    return _format2x_size(n_prb, 0)


def _riv_decode_vrb(riv: int, n_prb: int, n_vrb: int) -> tuple[int, int]:
    """RIV with modulus n_prb capped at n_vrb VRBs (ra.c type2_from_riv)."""
    l_crb = riv // n_prb + 1
    rb_start = riv % n_prb
    if rb_start + l_crb > n_vrb:
        l_crb = n_prb - riv // n_prb + 1
        rb_start = n_prb - riv % n_prb - 1
    return rb_start, l_crb


@dataclass(frozen=True)
class Dci1B:
    """Compact closed-loop rank-1 grant with TPMI (TM6)."""

    rb_start: int
    l_crb: int
    mcs: int
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    tpmi: int = 0
    pconf: int = 0  # PMI confirmation
    dist: int = 0  # 0 = localized VRB, 1 = distributed
    ngap2: int = 0  # distributed gap selector (0 = N_gap,1)

    def grant(self, n_prb: int, rnti: int | None = None) -> DlGrant:
        if self.dist:
            return DlGrant.type2_dist(n_prb, self.rb_start, self.l_crb,
                                      self.mcs, self.rv,
                                      ngap_is_1=not self.ngap2)
        return DlGrant.type2(n_prb, self.rb_start, self.l_crb, self.mcs, self.rv)


def _pack_format1bd(d, n_prb: int, n_ports: int, last_field: int) -> np.ndarray:
    bits = np.zeros(format1b_size(n_prb, n_ports), np.uint8)
    pos = _put(bits, 0, d.dist, 1)
    nb_gap = 0
    if d.dist and n_prb >= 50:
        nb_gap = 1
        pos = _put(bits, pos, d.ngap2, 1)
    pos = _put(bits, pos, riv_type2(n_prb, d.rb_start, d.l_crb),
               riv_nbits(n_prb) - nb_gap)
    pos = _put(bits, pos, d.mcs, 5)
    pos = _put(bits, pos, d.harq_pid, 3)
    pos = _put(bits, pos, d.ndi, 1)
    pos = _put(bits, pos, d.rv, 2)
    pos = _put(bits, pos, d.tpc, 2)
    pos = _put(bits, pos, d.tpmi, tpmi_bits(n_ports))
    _put(bits, pos, last_field, 1)
    return bits


def _unpack_format1bd(bits: np.ndarray, n_prb: int, n_ports: int):
    pos = 0
    dist, pos = _get(bits, pos, 1)
    ngap2 = 0
    nb_gap = 0
    if dist and n_prb >= 50:
        nb_gap = 1
        ngap2, pos = _get(bits, pos, 1)
    riv, pos = _get(bits, pos, riv_nbits(n_prb) - nb_gap)
    mcs, pos = _get(bits, pos, 5)
    harq, pos = _get(bits, pos, 3)
    ndi, pos = _get(bits, pos, 1)
    rv, pos = _get(bits, pos, 2)
    tpc, pos = _get(bits, pos, 2)
    tpmi, pos = _get(bits, pos, tpmi_bits(n_ports))
    last, pos = _get(bits, pos, 1)
    n_vrb = type2_n_vrb_dl(n_prb, not ngap2) if dist else n_prb
    if riv >= n_prb * (n_prb + 1) // 2:
        return None
    rb_start, l_crb = _riv_decode_vrb(riv, n_prb, n_vrb)
    if rb_start + l_crb > n_vrb:
        return None
    return (rb_start, l_crb, mcs, harq, ndi, rv, tpc, tpmi, last, dist, ngap2)


def pack_format1b(d: Dci1B, n_prb: int, n_ports: int = 2) -> np.ndarray:
    return _pack_format1bd(d, n_prb, n_ports, d.pconf)


def unpack_format1b(bits: np.ndarray, n_prb: int, n_ports: int = 2) -> Dci1B | None:
    f = _unpack_format1bd(bits, n_prb, n_ports)
    return None if f is None else Dci1B(*f)


@dataclass(frozen=True)
class Dci1D:
    """Compact multi-user MIMO grant with TPMI + power offset (TM5)."""

    rb_start: int
    l_crb: int
    mcs: int
    harq_pid: int = 0
    ndi: int = 0
    rv: int = 0
    tpc: int = 0
    tpmi: int = 0
    power_offset: int = 0
    dist: int = 0
    ngap2: int = 0

    grant = Dci1B.grant


def pack_format1d(d: Dci1D, n_prb: int, n_ports: int = 2) -> np.ndarray:
    return _pack_format1bd(d, n_prb, n_ports, d.power_offset)


def unpack_format1d(bits: np.ndarray, n_prb: int, n_ports: int = 2) -> Dci1D | None:
    f = _unpack_format1bd(bits, n_prb, n_ports)
    return None if f is None else Dci1D(*f)


@dataclass(frozen=True)
class Dci1C:
    """Very compact broadcast grant (SI/RA/P-RNTI): distributed type 2 only.

    `mcs` is I_TBS into the 1C TBS table directly (36.213 §7.1.7.2.3);
    modulation is always QPSK.
    """

    rb_start: int  # in units of N_RB_step VRBs
    l_crb: int  # in units of N_RB_step VRBs
    mcs: int
    ngap2: int = 0

    def grant(self, n_prb: int, rnti: int | None = None, rv: int = 0) -> DlGrant:
        import dataclasses

        from ..modem.modem import Modulation
        from .ra import TBS_FORMAT1C

        step = type2_n_rb_step(n_prb)
        g = DlGrant.type2_dist(n_prb, self.rb_start * step, self.l_crb * step,
                               0, rv, ngap_is_1=not self.ngap2)
        return dataclasses.replace(
            g, tbs_override=TBS_FORMAT1C[self.mcs],
            mod_override=Modulation.QPSK)


def pack_format1c(d: Dci1C, n_prb: int) -> np.ndarray:
    bits = np.zeros(format1c_size(n_prb), np.uint8)
    pos = 0
    if n_prb >= 50:
        pos = _put(bits, pos, d.ngap2, 1)
    step = type2_n_rb_step(n_prb)
    n_vrb = type2_n_vrb_dl(n_prb, not d.ngap2) // step
    pos = _put(bits, pos, riv_type2(n_vrb, d.rb_start, d.l_crb),
               riv_nbits(type2_n_vrb_dl(n_prb, True) // step))
    _put(bits, pos, d.mcs, 5)
    return bits


def unpack_format1c(bits: np.ndarray, n_prb: int) -> Dci1C | None:
    pos = 0
    ngap2 = 0
    if n_prb >= 50:
        ngap2, pos = _get(bits, pos, 1)
    step = type2_n_rb_step(n_prb)
    riv, pos = _get(bits, pos, riv_nbits(type2_n_vrb_dl(n_prb, True) // step))
    mcs, pos = _get(bits, pos, 5)
    n_vrb = type2_n_vrb_dl(n_prb, not ngap2) // step
    if riv >= n_vrb * (n_vrb + 1) // 2:
        return None
    rb_start, l_crb = riv_type2_decode(n_vrb, riv)
    return Dci1C(rb_start, l_crb, mcs, ngap2)


TB_DISABLED = (0, 1)  # (mcs, rv) marking a disabled TB (36.213 §7.1.7.2)


@dataclass(frozen=True)
class Dci2:
    """Dual-TB grant for formats 2 (TM4), 2A (TM3), 2B (TM8).

    `alloc_type` 0 = RBG bitmap, 1 = RBG-subset VRB bitmap.  `swap` is the
    TB-to-codeword swap flag (scrambling-identity bit for 2B).  `pinfo` is
    the precoding information field (width depends on format/ports).
    """

    rbg_bitmask: int  # type 0: bitmap; type 1: vrb_bitmask
    mcs: tuple[int, int]
    rv: tuple[int, int] = (0, 0)
    ndi: tuple[int, int] = (0, 0)
    harq_pid: int = 0
    tpc: int = 0
    swap: int = 0
    pinfo: int = 0
    alloc_type: int = 0
    rbg_subset: int = 0  # type 1 only
    shift: int = 0  # type 1 only

    def tb_enabled(self, q: int) -> bool:
        return (self.mcs[q], self.rv[q]) != TB_DISABLED

    def grants(self, n_prb: int) -> tuple[DlGrant, DlGrant]:
        """Per-TB grants (same PRB set, per-TB MCS/RV)."""
        if self.alloc_type == 0:
            g0 = DlGrant.type0(n_prb, self.rbg_bitmask, self.mcs[0], self.rv[0])
            g1 = DlGrant.type0(n_prb, self.rbg_bitmask, self.mcs[1], self.rv[1])
        else:
            g0 = DlGrant.type1(n_prb, self.rbg_subset, bool(self.shift),
                               self.rbg_bitmask, self.mcs[0], self.rv[0])
            g1 = DlGrant.type1(n_prb, self.rbg_subset, bool(self.shift),
                               self.rbg_bitmask, self.mcs[1], self.rv[1])
        return g0, g1


def _pack_format2x(d: Dci2, n_prb: int, pbits: int, size: int) -> np.ndarray:
    bits = np.zeros(size, np.uint8)
    pos = 0
    if n_prb > 10:
        pos = _put(bits, pos, d.alloc_type, 1)
    p = rbg_size(n_prb)
    n_rbg = -(-n_prb // p)
    if d.alloc_type == 0:
        pos = _put(bits, pos, d.rbg_bitmask, n_rbg)
    else:
        subset_bits = math.ceil(math.log2(p))
        pos = _put(bits, pos, d.rbg_subset, subset_bits)
        pos = _put(bits, pos, d.shift, 1)
        pos = _put(bits, pos, d.rbg_bitmask, n_rbg - subset_bits - 1)
    pos = _put(bits, pos, d.tpc, 2)
    pos = _put(bits, pos, d.harq_pid, 3)
    pos = _put(bits, pos, d.swap, 1)
    for q in range(2):
        pos = _put(bits, pos, d.mcs[q], 5)
        pos = _put(bits, pos, d.ndi[q], 1)
        pos = _put(bits, pos, d.rv[q], 2)
    if pbits:
        pos = _put(bits, pos, d.pinfo, pbits)
    return bits


def _unpack_format2x(bits: np.ndarray, n_prb: int, pbits: int) -> Dci2:
    pos = 0
    alloc_type = 0
    if n_prb > 10:
        alloc_type, pos = _get(bits, pos, 1)
    p = rbg_size(n_prb)
    n_rbg = -(-n_prb // p)
    subset = shift = 0
    if alloc_type == 0:
        bitmask, pos = _get(bits, pos, n_rbg)
    else:
        subset_bits = math.ceil(math.log2(p))
        subset, pos = _get(bits, pos, subset_bits)
        shift, pos = _get(bits, pos, 1)
        bitmask, pos = _get(bits, pos, n_rbg - subset_bits - 1)
    tpc, pos = _get(bits, pos, 2)
    harq, pos = _get(bits, pos, 3)
    swap, pos = _get(bits, pos, 1)
    mcs, ndi, rv = [], [], []
    for _ in range(2):
        m, pos = _get(bits, pos, 5)
        n, pos = _get(bits, pos, 1)
        r, pos = _get(bits, pos, 2)
        mcs.append(m)
        ndi.append(n)
        rv.append(r)
    pinfo = 0
    if pbits:
        pinfo, pos = _get(bits, pos, pbits)
    return Dci2(bitmask, tuple(mcs), tuple(rv), tuple(ndi), harq, tpc, swap,
                pinfo, alloc_type, subset, shift)


def pack_format2(d: Dci2, n_prb: int, n_ports: int = 2) -> np.ndarray:
    return _pack_format2x(d, n_prb, precoding_bits_f2(n_ports),
                          format2_size(n_prb, n_ports))


def unpack_format2(bits: np.ndarray, n_prb: int, n_ports: int = 2) -> Dci2:
    return _unpack_format2x(bits, n_prb, precoding_bits_f2(n_ports))


def pack_format2a(d: Dci2, n_prb: int, n_ports: int = 2) -> np.ndarray:
    return _pack_format2x(d, n_prb, precoding_bits_f2a(n_ports),
                          format2a_size(n_prb, n_ports))


def unpack_format2a(bits: np.ndarray, n_prb: int, n_ports: int = 2) -> Dci2:
    return _unpack_format2x(bits, n_prb, precoding_bits_f2a(n_ports))


def pack_format2b(d: Dci2, n_prb: int, n_ports: int = 2) -> np.ndarray:
    return _pack_format2x(d, n_prb, 0, format2b_size(n_prb, n_ports))


def unpack_format2b(bits: np.ndarray, n_prb: int, n_ports: int = 2) -> Dci2:
    return _unpack_format2x(bits, n_prb, 0)
