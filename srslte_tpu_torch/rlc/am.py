"""RLC AM: acknowledged mode (36.322 §5.2, rlc_am_lte.cc equivalent).

Covered behaviors: AMD PDU build with concatenation/segmentation and poll
bits, tx window with retransmission on NACK, STATUS PDU generation (ACK_SN +
NACK list) triggered by polls and t-Reordering expiry, status prohibit,
in-order delivery with reassembly, max-retx escalation flag
(rlc_am_lte.cc:164-170 -> RRC radio-link-failure in the reference), and
re-segmentation of retransmitted PDUs when the grant shrinks (RF=1 AMD PDU
segments with LSF/SO, 36.322 §6.2.1.5, rlc_am_lte.cc build_segment):
the receiver reconstructs the original PDU's data field byte-by-byte from
the SO offsets and recovers SDU boundaries from each segment's own LIs.

SO-granular STATUS NACKs (E2=1, 36.322 §6.2.2.5): a receiver holding only
parts of a re-segmented PDU NACKs just the missing byte ranges
(SOstart/SOend, with the 0x7FFF open-tail marker), and the transmitter
retransmits exactly those ranges as RF=1 segments.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

from .bits import BitReader, BitWriter
from .reassembly import Reassembler

SN_MOD = 1024
WINDOW = SN_MOD // 2


@dataclass
class AmdPdu:
    sn: int
    fi: int
    poll: bool
    segments: list


@dataclass
class AmdSegPdu:
    """RF=1 re-segmentation PDU: a byte range [so, so+len) of the original
    AMD PDU's data field, with its own FI/LI view of that range."""

    sn: int
    fi: int
    poll: bool
    lsf: bool
    so: int
    segments: list


def _pack_header(w: BitWriter, rf: int, poll: bool, fi: int, lis: list,
                 sn: int):
    w.put(1, 1)  # D/C = data
    w.put(rf, 1)
    w.put(1 if poll else 0, 1)
    w.put(fi, 2)
    w.put(1 if lis else 0, 1)
    w.put(sn, 10)


def _pack_lis(w: BitWriter, lis: list):
    for i, li in enumerate(lis):
        w.put(1 if i < len(lis) - 1 else 0, 1)
        w.put(li, 11)


def pack_amd(pdu: AmdPdu) -> bytes:
    w = BitWriter()
    lis = [len(s) for s in pdu.segments[:-1]]
    _pack_header(w, 0, pdu.poll, pdu.fi, lis, pdu.sn)
    _pack_lis(w, lis)
    return w.to_bytes() + b"".join(pdu.segments)


def pack_amd_seg(pdu: AmdSegPdu) -> bytes:
    w = BitWriter()
    lis = [len(s) for s in pdu.segments[:-1]]
    _pack_header(w, 1, pdu.poll, pdu.fi, lis, pdu.sn)
    w.put(1 if pdu.lsf else 0, 1)
    w.put(pdu.so, 15)
    _pack_lis(w, lis)
    return w.to_bytes() + b"".join(pdu.segments)


def unpack_amd(raw: bytes):
    """-> AmdPdu (RF=0) or AmdSegPdu (RF=1)."""
    r = BitReader(raw)
    assert r.get(1) == 1  # data
    rf = r.get(1)
    poll = bool(r.get(1))
    fi = r.get(2)
    e = r.get(1)
    sn = r.get(10)
    lsf, so = False, 0
    if rf:
        lsf = bool(r.get(1))
        so = r.get(15)
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
    if rf:
        return AmdSegPdu(sn, fi, poll, lsf, so, segs)
    return AmdPdu(sn, fi, poll, segs)


SO_END_ALL = 0x7FFF  # SOend special value: "through the last byte" (36.322)


def pack_status(ack_sn: int, nacks: list) -> bytes:
    """STATUS PDU (36.322 §6.2.2.5): ACK_SN, E1, then chained NACK entries
    NACK_SN + E1 + E2 [+ SOstart(15) + SOend(15) when E2 = 1].

    `nacks` entries are either a bare SN (whole PDU missing) or a tuple
    (sn, so_start, so_end) for a byte-range NACK (rlc_am_lte.cc STATUS with
    segment offsets).
    """
    w = BitWriter()
    w.put(0, 1)  # D/C = control
    w.put(0, 3)  # CPT = STATUS
    w.put(ack_sn, 10)
    w.put(1 if nacks else 0, 1)  # E1 after ACK_SN
    for i, n in enumerate(nacks):
        if isinstance(n, tuple):
            sn, so_start, so_end = n
        else:
            sn, so_start, so_end = n, None, None
        w.put(sn, 10)
        w.put(1 if i + 1 < len(nacks) else 0, 1)  # E1: another NACK follows
        w.put(1 if so_start is not None else 0, 1)  # E2: SO fields follow
        if so_start is not None:
            w.put(so_start, 15)
            w.put(so_end, 15)
    return w.to_bytes()


def unpack_status(raw: bytes):
    """-> (ack_sn, [sn | (sn, so_start, so_end), ...])."""
    r = BitReader(raw)
    assert r.get(1) == 0
    assert r.get(3) == 0
    ack_sn = r.get(10)
    nacks = []
    more = r.get(1)
    while more:
        sn = r.get(10)
        more = r.get(1)
        e2 = r.get(1)
        if e2:
            so_start = r.get(15)
            so_end = r.get(15)
            nacks.append((sn, so_start, so_end))
        else:
            nacks.append(sn)
    return ack_sn, nacks


def is_control(raw: bytes) -> bool:
    return (raw[0] >> 7) == 0


@dataclass
class RlcAm:
    poll_pdu: int = 4  # poll every N PDUs
    max_retx: int = 8
    t_reordering: int = 5
    t_status_prohibit: int = 0
    # TX state
    _queue: deque = field(default_factory=deque)
    _partial: bytes = b""
    _vt_s: int = 0
    _vt_a: int = 0
    _tx_window: dict = field(default_factory=dict)  # sn -> (raw, n_tx, pdu)
    _retx: deque = field(default_factory=deque)
    _seg_so: dict = field(default_factory=dict)  # sn -> next resume offset
    _retx_range: dict = field(default_factory=dict)  # sn -> [(so_s, so_e)..]
    _pdus_since_poll: int = 0
    max_retx_reached: bool = False
    # t-PollRetransmit (36.322 §5.2.2.3): re-poll when a STATUS never comes
    t_poll_retx: int = 4
    _poll_t_active: bool = False
    _poll_t_count: int = 0
    _poll_sn: int = 0  # SN of the last PDU sent with poll = 1
    # RX state
    _rx_window: dict = field(default_factory=dict)
    _vr_r: int = 0  # next SN expected in sequence
    _vr_h: int = 0  # highest SN received + 1
    _do_status: bool = False
    _status_wait: int = 0
    _t_active: bool = False
    _t_count: int = 0
    _vr_x: int = 0
    _reasm: Reassembler = field(default_factory=Reassembler)
    _rx_segs: dict = field(default_factory=dict)  # sn -> {so: AmdSegPdu}

    # convenience
    @property
    def rx_sdus(self) -> list:
        return self._reasm.sdus

    @staticmethod
    def _lt(a: int, b: int) -> bool:
        return ((a - b) % SN_MOD) > WINDOW

    # ---- TX -------------------------------------------------------------
    def write_sdu(self, sdu: bytes):
        self._queue.append(bytes(sdu))

    def get_buffer_state(self) -> int:
        n = len(self._partial) + sum(len(s) for s in self._queue)
        retx = sum(len(self._tx_window[sn][0]) for sn in self._retx
                   if sn in self._tx_window)
        status = 2 if self._do_status and self._status_wait == 0 else 0
        return n + (4 if n else 0) + retx + status

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        # 1. pending STATUS has priority (rlc_am_lte.cc read_pdu order)
        if self._do_status and self._status_wait == 0:
            pdu = self._build_status()
            if len(pdu) <= nof_bytes:
                self._do_status = False
                self._status_wait = self.t_status_prohibit
                return pdu
        # 2. retransmissions (re-segmented if the grant shrank; byte-range
        #    only when the peer sent SO-granular NACKs)
        while self._retx:
            sn = self._retx[0]
            ent = self._tx_window.get(sn)
            if ent is None:
                self._retx.popleft()
                self._retx_range.pop(sn, None)
                continue
            raw, n_tx, pdu = ent
            ranges = self._retx_range.get(sn)
            if ranges:
                total = sum(len(s) for s in pdu.segments)
                start, end_inc = ranges[0]
                end = total if end_inc >= SO_END_ALL else min(end_inc + 1,
                                                              total)
                so = self._seg_so.get(sn, start)
                seg = self._build_segment(pdu, so, nof_bytes, cap=end)
                if seg is None:
                    return None
                seg_end = seg.so + sum(len(s) for s in seg.segments)
                if seg_end >= end:
                    ranges.pop(0)
                    self._seg_so.pop(sn, None)
                    if not ranges:
                        self._retx_range.pop(sn, None)
                        self._retx.popleft()
                        if n_tx + 1 >= self.max_retx:
                            self.max_retx_reached = True
                        self._tx_window[sn] = (raw, n_tx + 1, pdu)
                else:
                    self._seg_so[sn] = seg_end
                return pack_amd_seg(seg)
            so = self._seg_so.get(sn, 0)
            if so == 0 and len(raw) <= nof_bytes:
                self._retx.popleft()
                if n_tx + 1 >= self.max_retx:
                    self.max_retx_reached = True  # RRC escalation signal
                self._tx_window[sn] = (raw, n_tx + 1, pdu)
                return raw
            seg = self._build_segment(pdu, so, nof_bytes)
            if seg is None:
                return None  # grant too small for any forward progress
            if seg.lsf:
                self._seg_so.pop(sn, None)
                self._retx.popleft()
                if n_tx + 1 >= self.max_retx:
                    self.max_retx_reached = True
                self._tx_window[sn] = (raw, n_tx + 1, pdu)
            else:
                self._seg_so[sn] = seg.so + sum(len(s) for s in seg.segments)
            return pack_amd_seg(seg)
        # 3. new data
        if not self._partial and not self._queue:
            return None
        segs: list[bytes] = []
        first_cont = bool(self._partial)
        space = nof_bytes - 3  # header estimate
        if space <= 0:
            return None
        if first_cont:
            take = min(len(self._partial), space)
            segs.append(self._partial[:take])
            self._partial = self._partial[take:]
            space -= take
        while self._queue and space > 2:
            if segs:
                space -= 2
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
        if not segs or not any(segs):
            return None
        self._pdus_since_poll += 1
        poll = (self._pdus_since_poll >= self.poll_pdu
                or (not self._queue and not self._partial))
        if poll:
            self._pdus_since_poll = 0
        fi = (2 if first_cont else 0) | (1 if self._partial else 0)
        sn = self._vt_s
        self._vt_s = (self._vt_s + 1) % SN_MOD
        pdu = AmdPdu(sn, fi, poll, segs)
        raw = pack_amd(pdu)
        self._tx_window[sn] = (raw, 1, pdu)
        if poll:
            self._poll_t_active, self._poll_t_count = True, 0
            self._poll_sn = sn
        return raw

    def _build_segment(self, pdu: AmdPdu, so: int, nof_bytes: int,
                       cap: int | None = None) -> AmdSegPdu | None:
        """Largest RF=1 segment of pdu's data field starting at so that
        fits in nof_bytes (fixed header 4B + 12 bits per extra LI).
        `cap` bounds the segment end (SO-granular retransmission)."""
        data = b"".join(pdu.segments)
        total = len(data)
        bounds = []  # byte offsets where a new SDU starts (excl. 0/total)
        pos = 0
        for s in pdu.segments[:-1]:
            pos += len(s)
            bounds.append(pos)
        limit = total if cap is None else min(cap, total)
        take = min(nof_bytes - 4, limit - so)
        for _ in range(8):  # shrink until LI overhead fits (converges fast)
            if take <= 0:
                return None
            n_li = sum(1 for b in bounds if so < b < so + take)
            hdr = (32 + 12 * n_li + 7) // 8
            if hdr + take <= nof_bytes:
                break
            take = nof_bytes - hdr
        else:
            return None
        end = so + take
        cuts = [so] + [b for b in bounds if so < b < end] + [end]
        segs = [data[a:b] for a, b in zip(cuts[:-1], cuts[1:])]
        # FI first bit: segment starts mid-SDU unless so is an SDU boundary
        first_cont = (pdu.fi & 2 != 0) if so == 0 else (so not in bounds)
        last_cont = (pdu.fi & 1 != 0) if end == total else (end not in bounds)
        fi = (2 if first_cont else 0) | (1 if last_cont else 0)
        lsf = end == total
        return AmdSegPdu(pdu.sn, fi, pdu.poll and lsf, lsf, so, segs)

    def _build_status(self) -> bytes:
        nacks = []
        sn = self._vr_r
        while sn != self._vr_h:
            if sn not in self._rx_window:
                ranges = self._missing_ranges(sn)
                if ranges is None:
                    nacks.append(sn)  # nothing of this SN arrived
                else:
                    nacks.extend((sn, a, b) for a, b in ranges)
            sn = (sn + 1) % SN_MOD
        return pack_status(self._vr_h, nacks)

    def _missing_ranges(self, sn: int) -> list | None:
        """Byte ranges of sn not yet received (SO-granular NACK payloads),
        as inclusive (so_start, so_end) with SO_END_ALL for an open tail.
        None when no segment of sn has arrived at all."""
        parts = self._rx_segs.get(sn)
        if not parts:
            return None
        ivs = sorted((p.so, p.so + sum(len(s) for s in p.segments))
                     for p in parts.values())
        lsf = next((p for p in parts.values() if p.lsf), None)
        total = (lsf.so + sum(len(s) for s in lsf.segments)) if lsf else None
        out = []
        cur = 0
        for a, b in ivs:
            if a > cur:
                out.append((cur, a - 1))
            cur = max(cur, b)
        if total is None:
            out.append((cur, SO_END_ALL))
        elif cur < total:
            out.append((cur, total - 1))
        return out

    # ---- RX -------------------------------------------------------------
    def write_pdu(self, raw: bytes):
        if is_control(raw):
            self._handle_status(raw)
            return
        pdu = unpack_amd(raw)
        sn = pdu.sn
        if self._lt(sn, self._vr_r) or sn in self._rx_window:
            if pdu.poll:
                self._do_status = True
            return  # duplicate / stale
        if isinstance(pdu, AmdSegPdu):
            whole = self._collect_segment(pdu)
            if whole is None:
                # a received *portion* still advances VR(H) and arms
                # t-Reordering (36.322 §5.1.3.2.1 counts byte segments)
                if not self._lt(sn, self._vr_h):
                    self._vr_h = (sn + 1) % SN_MOD
                if self._vr_r != self._vr_h and not self._t_active:
                    self._t_active, self._t_count = True, 0
                    self._vr_x = self._vr_h
                if pdu.poll:
                    self._do_status = True
                return  # not yet complete
            pdu = whole
        self._rx_window[sn] = pdu
        if not self._lt(sn, self._vr_h):
            self._vr_h = (sn + 1) % SN_MOD
        if pdu.poll:
            self._do_status = True
        # in-order delivery
        while self._vr_r in self._rx_window:
            p = self._rx_window[self._vr_r]
            self._reasm.push(p.segments, p.fi)
            # keep the PDU marker so duplicates are recognized, drop payload
            self._rx_window[self._vr_r] = AmdPdu(p.sn, p.fi, False, [])
            self._rx_window.pop((self._vr_r - WINDOW) % SN_MOD, None)
            self._vr_r = (self._vr_r + 1) % SN_MOD
        if self._vr_r != self._vr_h and not self._t_active:
            self._t_active, self._t_count, self._vr_x = True, 0, self._vr_h

    def _collect_segment(self, seg: AmdSegPdu) -> AmdPdu | None:
        """Accumulate RF=1 parts; return the rebuilt AMD PDU once the byte
        range [0, total) is fully covered and the LSF part has arrived."""
        parts = self._rx_segs.setdefault(seg.sn, {})
        parts[seg.so] = seg
        lsf = next((p for p in parts.values() if p.lsf), None)
        if lsf is None:
            return None
        total = lsf.so + sum(len(s) for s in lsf.segments)
        data = bytearray(total)
        covered = bytearray(total)
        splits = set()
        fi = 0
        poll = False
        for p in parts.values():
            poll |= p.poll
            pos = p.so
            for i, piece in enumerate(p.segments):
                if i > 0:
                    splits.add(pos)  # an LI boundary: a new SDU starts here
                data[pos : pos + len(piece)] = piece
                for k in range(pos, min(pos + len(piece), total)):
                    covered[k] = 1
                pos += len(piece)
            if p.so == 0:
                fi |= p.fi & 2
            elif not (p.fi & 2):
                splits.add(p.so)  # segment's first byte starts an SDU
            if p.lsf:
                fi |= p.fi & 1
        if not all(covered):
            return None
        del self._rx_segs[seg.sn]
        cuts = [0] + sorted(s for s in splits if 0 < s < total) + [total]
        segs = [bytes(data[a:b]) for a, b in zip(cuts[:-1], cuts[1:])]
        return AmdPdu(seg.sn, fi, poll, segs)

    def _handle_status(self, raw: bytes):
        ack_sn, nacks = unpack_status(raw)
        nack_sns = set()
        ranges: dict[int, list] = {}
        for n in nacks:
            if isinstance(n, tuple):
                nack_sns.add(n[0])
                ranges.setdefault(n[0], []).append((n[1], n[2]))
            else:
                nack_sns.add(n)
        sn = self._vt_a
        while sn != ack_sn:
            if sn in nack_sns:
                if sn not in self._retx:
                    self._retx.append(sn)
                if sn in ranges:
                    self._retx_range[sn] = ranges[sn]
                else:
                    self._retx_range.pop(sn, None)  # whole-PDU NACK wins
            else:
                self._tx_window.pop(sn, None)
            sn = (sn + 1) % SN_MOD
        # advance vt_a past contiguously acked PDUs
        while self._vt_a != ack_sn and self._vt_a not in nack_sns:
            self._vt_a = (self._vt_a + 1) % SN_MOD
        # stop t-PollRetransmit only when POLL_SN is acked or nacked
        # (36.322 §5.2.2.3); an unrelated STATUS keeps the re-poll armed
        if self._poll_sn not in self._tx_window or self._poll_sn in nack_sns:
            self._poll_t_active = False

    def tick(self):
        if self._status_wait > 0:
            self._status_wait -= 1
        if self._t_active:
            self._t_count += 1
            if self._t_count >= self.t_reordering:
                self._t_active = False
                self._do_status = True  # report the holes
                if self._vr_r != self._vr_h:
                    self._t_active, self._t_count = True, 0
                    self._vr_x = self._vr_h
        if self._poll_t_active:
            self._poll_t_count += 1
            if self._poll_t_count >= self.t_poll_retx:
                self._poll_t_count = 0
                # re-poll: retransmit the newest unacked PDU with poll = 1
                # (rlc_am_lte.cc poll_retx timer expiry)
                sn = (self._vt_s - 1) % SN_MOD
                if sn in self._tx_window:
                    raw, n_tx, pdu = self._tx_window[sn]
                    if not pdu.poll:
                        import dataclasses

                        pdu = dataclasses.replace(pdu, poll=True)
                        self._tx_window[sn] = (pack_amd(pdu), n_tx, pdu)
                    if sn not in self._retx:
                        self._retx.append(sn)
                else:
                    self._poll_t_active = False
