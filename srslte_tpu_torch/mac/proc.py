"""UE MAC reporting procedures: BSR, PHR, SR (36.321 §5.4.5/§5.4.6/§5.4.4).

Reference behavior: srsue/src/stack/mac/{proc_bsr.cc, proc_phr.cc,
proc_sr.cc} — periodic + regular BSR with the 36.321 table 6.1.3.1-1 buffer
size index, power-headroom CE mapping, SR pending flag toward PUCCH.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# 36.321 table 6.1.3.1-1 buffer size levels (bytes); index = largest level
# <= amount (spec constants)
BSR_TABLE = (
    0, 1, 10, 12, 14, 17, 19, 22, 26, 31, 36, 42, 49, 57, 67, 78,
    91, 107, 125, 146, 171, 200, 234, 274, 321, 376, 440, 515, 603, 706,
    826, 967, 1132, 1326, 1552, 1817, 2127, 2490, 2915, 3413, 3995, 4667,
    5476, 6411, 7505, 8787, 10287, 12043, 14099, 16507, 19325, 22624, 26487,
    31009, 36304, 42502, 49759, 58255, 68201, 79846, 93479, 109439, 128125,
    150000)


def bsr_index(nof_bytes: int) -> int:
    """Buffer size index 0..63 (largest level <= nof_bytes; 63 = >150000)."""
    if nof_bytes <= 0:
        return 0
    for i in range(63, -1, -1):
        if nof_bytes >= BSR_TABLE[i]:
            return i
    return 0


def bsr_bytes(index: int) -> int:
    """Upper-bound bytes the index reports (pdu.cc btable semantics)."""
    return BSR_TABLE[min(index + 1, 63)] if index < 63 else BSR_TABLE[63]


def short_bsr_ce(lcg: int, nof_bytes: int) -> bytes:
    """Short/Truncated BSR CE: [LCG(2) | buffer size(6)]."""
    return bytes([((lcg & 0x3) << 6) | bsr_index(nof_bytes)])


def long_bsr_ce(bytes_per_lcg: list) -> bytes:
    """Long BSR CE: four 6-bit indices packed into 3 bytes."""
    idx = [bsr_index(b) for b in bytes_per_lcg] + [0] * (4 - len(bytes_per_lcg))
    v = (idx[0] << 18) | (idx[1] << 12) | (idx[2] << 6) | idx[3]
    return v.to_bytes(3, "big")


def parse_long_bsr(ce: bytes) -> list:
    v = int.from_bytes(ce[:3], "big")
    return [(v >> s) & 0x3F for s in (18, 12, 6, 0)]


def phr_ce(ph_db: float) -> bytes:
    """PHR CE: 6-bit level for PH in [-23, +40] dB (table 6.1.3.6-1)."""
    lvl = int(round(ph_db)) + 23
    return bytes([max(0, min(63, lvl)) & 0x3F])


def parse_phr(ce: bytes) -> float:
    return float((ce[0] & 0x3F) - 23)


@dataclass
class BsrProc:
    """Regular + periodic BSR triggering (proc_bsr.cc lite)."""

    periodic_timer: int = 16  # TTIs; 0 = off
    _count: int = 0
    _last_reported: int = 0
    triggered: bool = False

    def buffer_state_changed(self, total_bytes: int):
        """Regular BSR: new data for a previously-empty buffer."""
        if total_bytes > 0 and self._last_reported == 0:
            self.triggered = True
        self._last_reported = total_bytes

    def tick(self):
        if self.periodic_timer:
            self._count += 1
            if self._count >= self.periodic_timer:
                self._count = 0
                if self._last_reported > 0:
                    self.triggered = True

    def generate(self, lcg_bytes: dict) -> bytes | None:
        """-> (is_long, CE bytes) when triggered, else None."""
        if not self.triggered:
            return None
        self.triggered = False
        active = [g for g, b in lcg_bytes.items() if b > 0]
        if len(active) <= 1:
            g = active[0] if active else 0
            return short_bsr_ce(g, lcg_bytes.get(g, 0))
        return long_bsr_ce([lcg_bytes.get(g, 0) for g in range(4)])


@dataclass
class SrProc:
    """Scheduling request toward PUCCH format 1 (proc_sr.cc lite)."""

    max_sr: int = 8
    pending: bool = False
    count: int = 0
    failed: bool = False

    def trigger(self):
        self.pending = True

    def sr_opportunity(self) -> bool:
        """True -> transmit SR on the PUCCH SR resource this TTI."""
        if not self.pending:
            return False
        self.count += 1
        if self.count > self.max_sr:
            self.pending = False
            self.failed = True  # -> RRC: release PUCCH, start RA
            return False
        return True

    def grant_received(self):
        self.pending = False
        self.count = 0
