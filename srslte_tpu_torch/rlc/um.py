"""RLC UM: unacknowledged mode with 10-bit SN (36.322 §5.1.2, rlc_um_lte.cc).

TX: SDU queue -> PDUs of the MAC-requested size with concatenation and
segmentation (FI bits + 11-bit LIs).  RX: reordering window, t-Reordering
modeled as tick counts, reassembly across PDUs (rlc_um_lte.cc rx window).
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .bits import BitReader, BitWriter
from .reassembly import Reassembler

SN_MOD = 1024
WINDOW = SN_MOD // 2


@dataclass
class UmdPdu:
    sn: int
    fi: int  # bit1: first byte is continuation; bit0: last byte is not SDU end
    segments: list  # list of bytes (LI-delimited chunks)


def pack_umd(pdu: UmdPdu) -> bytes:
    w = BitWriter()
    lis = [len(s) for s in pdu.segments[:-1]]
    w.put(0, 3)  # R1
    w.put(pdu.fi, 2)
    w.put(1 if lis else 0, 1)
    w.put(pdu.sn, 10)
    for i, li in enumerate(lis):
        w.put(1 if i < len(lis) - 1 else 0, 1)
        w.put(li, 11)
    hdr = w.to_bytes()
    return hdr + b"".join(pdu.segments)


def unpack_umd(raw: bytes) -> UmdPdu:
    r = BitReader(raw)
    r.get(3)
    fi = r.get(2)
    e = r.get(1)
    sn = r.get(10)
    lis = []
    while e:
        e = r.get(1)
        lis.append(r.get(11))
    r.align()
    data = r.rest()
    segs, pos = [], 0
    for li in lis:
        segs.append(data[pos : pos + li])
        pos += li
    segs.append(data[pos:])
    return UmdPdu(sn, fi, segs)


@dataclass
class RlcUm:
    t_reordering: int = 5  # ticks
    # TX state
    _queue: deque = field(default_factory=deque)
    _vt_us: int = 0
    _partial: bytes = b""  # remainder of a segmented SDU
    # RX state
    _rx_buf: dict = field(default_factory=dict)
    _vr_ur: int = 0  # earliest SN still considered for reordering
    _vr_uh: int = 0  # highest received SN + 1
    _t_active: bool = False
    _t_count: int = 0
    _vr_ux: int = 0
    _reasm: Reassembler = field(default_factory=Reassembler)

    @property
    def rx_sdus(self) -> list:
        return self._reasm.sdus

    # ---- TX -----------------------------------------------------------------
    def write_sdu(self, sdu: bytes):
        self._queue.append(bytes(sdu))

    def get_buffer_state(self) -> int:
        n = len(self._partial) + sum(len(s) for s in self._queue)
        return n + (3 if n else 0)

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        """Build one UMD PDU up to nof_bytes (header included)."""
        if not self._partial and not self._queue:
            return None
        segs: list[bytes] = []
        first_is_cont = bool(self._partial)
        space = nof_bytes - 2  # fixed header
        if first_is_cont:
            take = min(len(self._partial), space)
            segs.append(self._partial[:take])
            self._partial = self._partial[take:]
            space -= take
        while self._queue and space > 2:
            if segs:
                space -= 2  # LI cost (12 bits, round up amortized)
                if space <= 0:
                    break
            sdu = self._queue.popleft()
            if len(sdu) <= space:
                segs.append(sdu)
                space -= len(sdu)
            else:
                segs.append(sdu[:space])
                self._partial = sdu[space:]
                space = 0
        if not segs or (len(segs) == 1 and not segs[0]):
            return None
        last_is_partial = bool(self._partial)
        fi = (2 if first_is_cont else 0) | (1 if last_is_partial else 0)
        pdu = UmdPdu(self._vt_us, fi, segs)
        self._vt_us = (self._vt_us + 1) % SN_MOD
        return pack_umd(pdu)

    # ---- RX -----------------------------------------------------------------
    def _sn_lt(self, a: int, b: int) -> bool:
        return ((a - b) % SN_MOD) > WINDOW

    def write_pdu(self, raw: bytes):
        pdu = unpack_umd(raw)
        sn = pdu.sn
        if self._sn_lt(sn, self._vr_ur):
            return  # outside the reordering window: drop
        self._rx_buf[sn] = pdu
        if not self._sn_lt(sn, self._vr_uh):
            self._vr_uh = (sn + 1) % SN_MOD
        self._deliver_in_order()
        if not self._t_active and self._vr_uh != self._vr_ur:
            self._t_active, self._t_count, self._vr_ux = True, 0, self._vr_uh

    def tick(self):
        """t-Reordering tick: advance past holes when it expires."""
        if not self._t_active:
            return
        self._t_count += 1
        if self._t_count >= self.t_reordering:
            self._t_active = False
            while self._vr_ur != self._vr_ux:
                if self._vr_ur not in self._rx_buf:
                    self._reasm.invalidate()  # lost a PDU mid-SDU
                self._deliver_sn(self._vr_ur)
                self._vr_ur = (self._vr_ur + 1) % SN_MOD
            self._deliver_in_order()
            if self._vr_uh != self._vr_ur:
                self._t_active, self._t_count, self._vr_ux = True, 0, self._vr_uh

    def _deliver_in_order(self):
        while self._vr_ur in self._rx_buf:
            self._deliver_sn(self._vr_ur)
            self._vr_ur = (self._vr_ur + 1) % SN_MOD

    def _deliver_sn(self, sn: int):
        pdu = self._rx_buf.pop(sn, None)
        if pdu is None:
            return
        self._reasm.push(pdu.segments, pdu.fi)
