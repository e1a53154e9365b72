"""SDU reassembly from FI/LI-delimited PDU segments (shared by UM and AM)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Reassembler:
    sdus: list = field(default_factory=list)
    _partial: bytes = b""
    _valid: bool = True

    def invalidate(self):
        """A PDU inside an SDU was lost: the in-flight partial is broken."""
        self._partial = b""
        self._valid = False

    def push(self, segments: list, fi: int):
        """Deliver one PDU's segments (fi bit1: first continues; bit0: last partial)."""
        first_cont = bool(fi & 2)
        last_part = bool(fi & 1)
        for i, s in enumerate(segments):
            closes = not (i == len(segments) - 1 and last_part)
            if i == 0 and first_cont:
                if self._valid:
                    self._partial += s
                if closes:
                    if self._valid and self._partial:
                        self.sdus.append(self._partial)
                    self._partial, self._valid = b"", True
            else:
                if i == 0 and self._partial:
                    self._partial, self._valid = b"", True  # stale partial
                if closes:
                    self.sdus.append(s)
                else:
                    self._partial, self._valid = s, True
