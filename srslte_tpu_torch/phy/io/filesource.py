"""Sample file source and sink (io/filesource.c, io/filesink.c equivalents).

Reference behavior: lib/src/phy/io/{filesource.c, filesink.c}: binary and
text IQ formats; the binary complex-float format is what the C library's
capture vectors (lib/src/phy/phch/test/signal*.dat) use and what
srsran_ue_sync_init_file replays (ue_sync.c:52).

Host code (numpy and file I/O): a capture is read into a complex64 numpy
array, which the receiver moves to the device in one copy.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

FORMATS = ("complex_float_bin", "complex_short_bin", "float_bin")


@dataclass
class FileSource:
    path: str
    fmt: str = "complex_float_bin"

    def __post_init__(self):
        if self.fmt not in FORMATS:
            raise ValueError(self.fmt)
        self._f = open(self.path, "rb")

    def read(self, n: int) -> np.ndarray:
        """Read up to n complex samples -> complex64 [m<=n]."""
        if self.fmt == "complex_float_bin":
            raw = np.fromfile(self._f, np.float32, 2 * n)
            raw = raw[: len(raw) // 2 * 2].reshape(-1, 2)
            return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)
        if self.fmt == "complex_short_bin":
            raw = np.fromfile(self._f, np.int16, 2 * n).astype(np.float32) / 32767.0
            raw = raw[: len(raw) // 2 * 2].reshape(-1, 2)
            return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)
        return np.fromfile(self._f, np.float32, n).astype(np.complex64)

    def seek(self, sample: int):
        bytes_per = {"complex_float_bin": 8, "complex_short_bin": 4,
                     "float_bin": 4}[self.fmt]
        self._f.seek(sample * bytes_per)

    def close(self):
        self._f.close()


@dataclass
class FileSink:
    path: str
    fmt: str = "complex_float_bin"

    def __post_init__(self):
        if self.fmt not in FORMATS:
            raise ValueError(self.fmt)
        self._f = open(self.path, "wb")

    def write(self, x: np.ndarray):
        x = np.asarray(x)
        if self.fmt == "complex_float_bin":
            out = np.empty((len(x), 2), np.float32)
            out[:, 0], out[:, 1] = x.real, x.imag
            out.tofile(self._f)
        elif self.fmt == "complex_short_bin":
            out = np.empty((len(x), 2), np.int16)
            out[:, 0] = np.clip(x.real * 32767, -32768, 32767)
            out[:, 1] = np.clip(x.imag * 32767, -32768, 32767)
            out.tofile(self._f)
        else:
            x.real.astype(np.float32).tofile(self._f)

    def close(self):
        self._f.close()
