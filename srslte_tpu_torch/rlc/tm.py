"""RLC TM: transparent mode (36.322 §4.2.1.1, rlc_tm.cc equivalent)."""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field


@dataclass
class RlcTm:
    _queue: deque = field(default_factory=deque)
    rx_sdus: list = field(default_factory=list)

    def write_sdu(self, sdu: bytes):
        self._queue.append(bytes(sdu))

    def get_buffer_state(self) -> int:
        return sum(len(s) for s in self._queue)

    def read_pdu(self, nof_bytes: int) -> bytes | None:
        """TM never segments: only emits an SDU that fits whole."""
        if self._queue and len(self._queue[0]) <= nof_bytes:
            return self._queue.popleft()
        return None

    def write_pdu(self, pdu: bytes):
        self.rx_sdus.append(bytes(pdu))
