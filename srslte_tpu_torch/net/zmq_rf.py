"""ZMQ virtual-RF transport, wire-compatible with the C library's rf_zmq.

Reference behavior: lib/src/phy/rf/rf_zmq_imp_{tx,rx}.c: the transmitter
BINDS a REP socket and answers each 1-byte request with a burst of CF32
samples (8 bytes each); the receiver is a REQ socket that sends the dummy
byte and reads the burst.  A srsRAN binary built with the ZMQ RF can
therefore exchange samples with this package directly
(tx_port=tcp://...:2000 <-> rx_port here, and vice versa).

pyzmq is imported when it is there; without it the classes raise when they
are built.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

try:
    import zmq
except ImportError:  # pyzmq is optional: the transport raises at use
    zmq = None


def _context():
    if zmq is None:
        raise RuntimeError("the ZMQ RF transport needs pyzmq, which is not installed")
    return zmq.Context.instance()


@dataclass
class ZmqTxServer:
    """The rf_zmq transmitter side: REP socket serving sample bursts."""

    bind: str = "tcp://127.0.0.1:2000"

    def __post_init__(self):
        self._sock = _context().socket(zmq.REP)
        self._sock.bind(self.bind)

    def serve_once(self, samples: np.ndarray, timeout_ms: int = 2000) -> bool:
        """Answer one receiver request with `samples` (complex64)."""
        if not self._sock.poll(timeout_ms, zmq.POLLIN):
            return False
        self._sock.recv()  # 1-byte dummy request
        self._sock.send(np.ascontiguousarray(samples, np.complex64).tobytes())
        return True

    def close(self):
        self._sock.close(0)


@dataclass
class ZmqRxClient:
    """The rf_zmq receiver side: REQ socket pulling sample bursts."""

    connect: str = "tcp://127.0.0.1:2000"

    def __post_init__(self):
        self._sock = _context().socket(zmq.REQ)
        self._sock.connect(self.connect)

    def recv(self, timeout_ms: int = 2000) -> np.ndarray | None:
        self._sock.send(b"\x00")  # dummy request byte
        if not self._sock.poll(timeout_ms, zmq.POLLIN):
            return None
        raw = self._sock.recv()
        return np.frombuffer(raw, np.complex64)

    def close(self):
        self._sock.close(0)
