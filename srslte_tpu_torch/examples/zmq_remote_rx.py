"""Remote IQ capture over the ZMQ virtual RF — lib/examples/zmq_remote_rx.c
analog.

Connects a REQ socket to a running rf_zmq transmitter (this framework's
ZmqTxServer or an srsRAN binary built with the ZMQ RF driver), pulls sample
bursts, and writes complex64 IQ to a file that
`srslte_tpu_torch.examples.pdsch_ue` decodes.  Host only: no tensor, no
device; it needs pyzmq (`net/zmq_rf.py`).

Usage: python -m srslte_tpu_torch.examples.zmq_remote_rx out.bin \
           --connect tcp://127.0.0.1:2000 --nof-samples 1920000
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..net.zmq_rf import ZmqRxClient


def capture(connect: str, nof_samples: int, timeout_ms: int = 2000):
    rx = ZmqRxClient(connect=connect)
    chunks, got = [], 0
    try:
        while got < nof_samples:
            burst = rx.recv(timeout_ms)
            if burst is None:
                print(f"timeout after {got} samples", file=sys.stderr)
                break
            chunks.append(burst)
            got += len(burst)
    finally:
        rx.close()
    out = (np.concatenate(chunks)[:nof_samples] if chunks
           else np.zeros(0, np.complex64))
    return out.astype(np.complex64)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("out")
    ap.add_argument("--connect", default="tcp://127.0.0.1:2000")
    ap.add_argument("--nof-samples", type=int, default=1920000)
    a = ap.parse_args(argv)
    samples = capture(a.connect, a.nof_samples)
    samples.tofile(a.out)
    print(f"captured {len(samples)} samples -> {a.out}")
    sys.exit(0 if len(samples) == a.nof_samples else 1)


if __name__ == "__main__":
    main()
