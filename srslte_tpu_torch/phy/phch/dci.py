"""DCI pack/unpack, format 1A (36.212 §5.3.3.1).

Reference behavior: lib/src/phy/phch/dci.c (dci_format1As_pack/unpack and the
*_sizeof functions: ambiguous-size table, format0/1A equalization).  The other
formats (0, 1, 1B, 1C, 1D, 2, 2A, 2B) are ROADMAP queue A item 8.

All host-side numpy: DCI payloads are control-plane data assembled on the
host; the device only sees the coded bit tensors (pdcch.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .ra import DlGrant, riv_type2, riv_type2_decode

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE
M_RNTI = 0xFFFD


def rnti_is_common(rnti: int) -> bool:
    """P/SI/RA-RNTI (not a UE C-RNTI) — SRSRAN_RNTI_ISUSER inverse."""
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
