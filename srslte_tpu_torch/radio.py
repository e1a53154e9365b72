"""Radio abstraction over virtual RF transports (lib/src/radio/radio.cc).

Reference behavior: radio.cc: rx_now/tx with sample timestamps, per-device
FFT resampling when the transport rate differs from the cell rate
(radio.cc:55-60), continuous-TX zero padding, pluggable RF backends
(rf_zmq_imp.c virtual RF is the no-hardware transport, rf_imp.c vtable).

Here the backends are the file source/sink (record/replay, ue_sync.c file
mode) and the C++ UDP sample pipe (the ZMQ-RF analog).  Samples cross the
transports as complex64 numpy on the host; the resampling between the
transport rate and the cell rate runs on the radio's device (`device`,
None meaning the CUDA device) through `resample_fft`.  Timestamps are
derived from sample counts at the transport rate, like rf_zmq_imp.c:113.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import gcd

import numpy as np
import torch

from ._device import resolve
from .phy.io import FileSink, FileSource
from .phy.resampling import resample_fft


def _resample_host(x: np.ndarray, up: int, down: int, device) -> np.ndarray:
    """Host in/out resampling on the device."""
    t = torch.as_tensor(np.ascontiguousarray(x, np.complex64)).to(resolve(device))
    return resample_fft(t, up, down).cpu().numpy()


@dataclass
class RadioTimestamp:
    sample_count: int
    srate: int

    @property
    def seconds(self) -> float:
        return self.sample_count / self.srate


class BaseRadio:
    """rx_now/tx interface (radio_interface_phy analog)."""

    def rx_now(self, n: int) -> tuple[np.ndarray, RadioTimestamp]:
        raise NotImplementedError

    def tx(self, samples: np.ndarray, ts: RadioTimestamp | None = None):
        raise NotImplementedError


@dataclass
class FileRadio(BaseRadio):
    """Record/replay radio (filesource/filesink + ue_sync file mode)."""

    rx_path: str | None = None
    tx_path: str | None = None
    srate: int = 1_920_000
    _rx_count: int = 0

    def __post_init__(self):
        self._src = FileSource(self.rx_path) if self.rx_path else None
        self._sink = FileSink(self.tx_path) if self.tx_path else None

    def rx_now(self, n: int):
        x = self._src.read(n)
        ts = RadioTimestamp(self._rx_count, self.srate)
        self._rx_count += len(x)
        if len(x) < n:  # end of capture: zero pad (radio returns silence)
            x = np.concatenate([x, np.zeros(n - len(x), np.complex64)])
        return x, ts

    def tx(self, samples, ts=None):
        self._sink.write(np.asarray(samples))

    def close(self):
        if self._src:
            self._src.close()
        if self._sink:
            self._sink.close()


@dataclass
class PipeRadio(BaseRadio):
    """Virtual RF over the native UDP sample pipe (rf_zmq_imp.c analog).

    Runs at a fixed base_srate (like the ZMQ RF's 23.04 Msps default)
    with FFT resampling to/from the cell rate when they differ.
    """

    tx_host: str = "127.0.0.1"
    tx_port: int = 2101
    rx_port: int = 2100
    base_srate: int = 1_920_000
    cell_srate: int = 1_920_000
    device: object = None
    _rx_count: int = 0

    def __post_init__(self):
        from .runtime import SamplePipeRx, SamplePipeTx

        self._tx = SamplePipeTx(self.tx_host, self.tx_port)
        self._rx = SamplePipeRx(self.rx_port)

    def _ratio(self):
        g = gcd(self.base_srate, self.cell_srate)
        return self.cell_srate // g, self.base_srate // g

    def rx_now(self, n: int):
        up, down = self._ratio()
        n_base = n * down // up
        x = self._rx.read(n_base, timeout_ms=2000)
        ts = RadioTimestamp(self._rx_count, self.base_srate)
        self._rx_count += len(x)
        if len(x) < n_base:
            x = np.concatenate([x, np.zeros(n_base - len(x), np.complex64)])
        if up != down:
            x = _resample_host(x, up, down, self.device)
        return x.astype(np.complex64), ts

    def tx(self, samples, ts=None):
        up, down = self._ratio()
        x = np.asarray(samples)
        if up != down:
            x = _resample_host(x, down, up, self.device)
        self._tx.send(x.astype(np.complex64))

    def close(self):
        self._tx.close()
        self._rx.close()
