"""NR RLC UM entity (38.322, rlc_um_nr.cc equivalent).

Reference behavior: lib/src/upper/rlc_um_nr.cc — header: SI(2) + SN(6 or
12 bits; full SDUs carry NO SN), 16-bit SO on last/middle segments
(read_data_pdu_header:590, write_data_pdu_header); RX keeps a reassembly
window keyed by SN with t-Reassembly; TX segments to the grant size with
the running SO.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

SI_FULL, SI_FIRST, SI_LAST, SI_MID = 0, 1, 2, 3


def pack_um_nr(si: int, sn: int, so: int, payload: bytes,
               sn_bits: int = 6) -> bytes:
    hdr = bytearray([si << 6])
    if si != SI_FULL:
        if sn_bits == 6:
            hdr[0] |= sn & 0x3F
        else:
            hdr[0] |= (sn >> 8) & 0x0F
            hdr.append(sn & 0xFF)
        if si in (SI_LAST, SI_MID):
            hdr += bytes([(so >> 8) & 0xFF, so & 0xFF])
    return bytes(hdr) + payload


def unpack_um_nr(raw: bytes, sn_bits: int = 6):
    """-> (si, sn, so, payload)."""
    si = (raw[0] >> 6) & 0x3
    pos = 1
    sn = so = 0
    if si != SI_FULL:
        if sn_bits == 6:
            sn = raw[0] & 0x3F
        else:
            sn = ((raw[0] & 0x0F) << 8) | raw[1]
            pos = 2
        if si in (SI_LAST, SI_MID):
            so = (raw[pos] << 8) | raw[pos + 1]
            pos += 2
    return si, sn, so, raw[pos:]


@dataclass
class RlcUmNr:
    """Unacknowledged mode, single-threaded entity (both directions)."""

    sn_bits: int = 6
    t_reassembly: int = 5
    # TX
    _queue: deque = field(default_factory=deque)
    _tx_sn: int = 0
    _partial: bytes = b""
    _partial_so: int = 0
    # RX
    _rx_segs: dict = field(default_factory=dict)  # sn -> {so: bytes}
    _rx_timer: dict = field(default_factory=dict)  # sn -> ticks left
    rx_sdus: list = field(default_factory=list)

    @property
    def _sn_mod(self) -> int:
        return 1 << self.sn_bits

    def write_sdu(self, sdu: bytes):
        self._queue.append(sdu)

    def get_buffer_state(self) -> int:
        return (len(self._partial) + sum(len(s) for s in self._queue)
                + (3 if self._partial or self._queue else 0))

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        hdr_full = 1
        hdr_seg = 1 + (0 if self.sn_bits == 6 else 1)
        if self._partial:
            space = nof_bytes - hdr_seg - 2  # SO present on last/middle
            if space <= 0:
                return None
            take = min(len(self._partial), space)
            chunk, self._partial = self._partial[:take], self._partial[take:]
            si = SI_LAST if not self._partial else SI_MID
            so = self._partial_so
            self._partial_so += take
            sn = self._tx_sn
            if si == SI_LAST:
                self._tx_sn = (self._tx_sn + 1) % self._sn_mod
                self._partial_so = 0
            return pack_um_nr(si, sn, so, chunk, self.sn_bits)
        if not self._queue:
            return None
        sdu = self._queue[0]
        if hdr_full + len(sdu) <= nof_bytes:
            self._queue.popleft()
            return pack_um_nr(SI_FULL, 0, 0, sdu, self.sn_bits)
        space = nof_bytes - hdr_seg
        if space <= 0:
            return None
        self._queue.popleft()
        self._partial = sdu[space:]
        self._partial_so = space
        return pack_um_nr(SI_FIRST, self._tx_sn, 0, sdu[:space], self.sn_bits)

    def write_pdu(self, raw: bytes):
        si, sn, so, payload = unpack_um_nr(raw, self.sn_bits)
        if si == SI_FULL:
            self.rx_sdus.append(payload)
            return
        parts = self._rx_segs.setdefault(sn, {})
        parts[(si, so)] = payload
        self._rx_timer[sn] = self.t_reassembly
        self._try_reassemble(sn)

    def _try_reassemble(self, sn: int):
        parts = self._rx_segs.get(sn, {})
        first = parts.get((SI_FIRST, 0))
        last = next(((k, v) for k, v in parts.items() if k[0] == SI_LAST),
                    None)
        if first is None or last is None:
            return
        total = last[0][1] + len(last[1])
        buf = bytearray(total)
        got = bytearray(total)
        for (si, so), data in parts.items():
            buf[so : so + len(data)] = data
            got[so : so + len(data)] = b"\x01" * len(data)
        if all(got):
            self.rx_sdus.append(bytes(buf))
            del self._rx_segs[sn]
            self._rx_timer.pop(sn, None)

    def tick(self):
        for sn in list(self._rx_timer):
            self._rx_timer[sn] -= 1
            if self._rx_timer[sn] <= 0:  # t-Reassembly expiry: discard
                self._rx_segs.pop(sn, None)
                del self._rx_timer[sn]
