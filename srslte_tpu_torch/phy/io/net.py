"""UDP sample source/sink (io/netsource.c, io/netsink.c equivalents).

Reference behavior: lib/src/phy/io/{netsource.c, netsink.c}: raw IQ over
UDP, used by zmq_remote_rx-style remote sample streaming.  Host code: the
rail that feeds device buffers.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import numpy as np

MAX_DGRAM = 1200 * 8  # samples per datagram * 8 bytes


@dataclass
class NetSink:
    host: str
    port: int

    def __post_init__(self):
        self._s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def write(self, x: np.ndarray):
        buf = np.empty((len(x), 2), np.float32)
        buf[:, 0], buf[:, 1] = np.real(x), np.imag(x)
        raw = buf.tobytes()
        for off in range(0, len(raw), MAX_DGRAM):
            self._s.sendto(raw[off : off + MAX_DGRAM], (self.host, self.port))

    def close(self):
        self._s.close()


@dataclass
class NetSource:
    host: str
    port: int
    timeout: float = 1.0

    def __post_init__(self):
        self._s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._s.bind((self.host, self.port))
        self._s.settimeout(self.timeout)

    def read(self, n: int) -> np.ndarray:
        """Blocking read of up to n complex samples (one or more datagrams)."""
        out = []
        got = 0
        while got < n:
            try:
                raw, _ = self._s.recvfrom(MAX_DGRAM)
            except socket.timeout:
                break
            arr = np.frombuffer(raw, np.float32).reshape(-1, 2)
            out.append(arr[:, 0] + 1j * arr[:, 1])
            got += len(arr)
        if not out:
            return np.zeros(0, np.complex64)
        return np.concatenate(out)[:n].astype(np.complex64)

    def close(self):
        self._s.close()
