"""ctypes bindings for the C++ host runtime (`runtime/srslte_tpu_native.cpp`).

The native layer provides the host-side rails the C library implements in
C/C++: a lock-free SPSC IQ ring buffer, a UDP sample pipe with a background
receiver thread, and a steady TTI clock.  This package keeps its own copy of
the source and builds it with g++ at first use (never at import) into
``srslte_tpu_torch/_build/`` under a name that carries a hash of the source,
as `ops/_build.py` names the CUDA libraries: an edited source is rebuilt and
a stale library is never loaded.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent / "srslte_tpu_native.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"


def lib_path() -> Path:
    digest = hashlib.sha1(SRC.read_bytes()).hexdigest()[:12]
    return BUILD / f"libsrslte_tpu_native-{digest}.so"


def build() -> Path:
    """Compile the source with g++ (unless its library exists); raises
    RuntimeError with the compiler's output if the build fails."""
    out = lib_path()
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    proc = subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread",
                           str(SRC), "-o", str(tmp)], capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed for {SRC.name}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


@functools.lru_cache(maxsize=None)
def lib() -> ctypes.CDLL:
    """The runtime library, built first if it is missing."""
    so = ctypes.CDLL(str(build()))
    u64, i64, f32p = ctypes.c_uint64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    vp = ctypes.c_void_p
    for name, res, args in (
            ("rb_create", vp, [u64]), ("rb_destroy", None, [vp]), ("rb_size", u64, [vp]),
            ("rb_write", u64, [vp, f32p, u64]), ("rb_read", u64, [vp, f32p, u64]),
            ("pipe_tx_create", vp, [ctypes.c_char_p, ctypes.c_int]),
            ("pipe_tx_destroy", None, [vp]), ("pipe_tx_send", i64, [vp, f32p, u64]),
            ("pipe_rx_create", vp, [ctypes.c_int, u64]),
            ("pipe_rx_read", u64, [vp, f32p, u64, ctypes.c_int]),
            ("pipe_rx_destroy", None, [vp]), ("ttic_create", vp, [u64]),
            ("ttic_now", u64, [vp]), ("ttic_wait", u64, [vp, u64, ctypes.c_int]),
            ("ttic_destroy", None, [vp])):
        fn = getattr(so, name)
        fn.restype, fn.argtypes = res, args
    return so


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _to_floats(x: np.ndarray) -> np.ndarray:
    """complex64 [n] -> interleaved float32 [2n] (or pass float32 through)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        out = np.empty(2 * len(x), np.float32)
        out[0::2], out[1::2] = x.real, x.imag
        return out
    return np.ascontiguousarray(x, np.float32)


def _to_complex(f: np.ndarray) -> np.ndarray:
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


class NativeRingBuffer:
    """SPSC IQ ring buffer (capacity in complex samples)."""

    def __init__(self, capacity: int):
        self._h = lib().rb_create(2 * capacity)

    def write(self, x: np.ndarray) -> int:
        f = _to_floats(x)
        return int(lib().rb_write(self._h, _fp(f), len(f))) // 2

    def read(self, n: int) -> np.ndarray:
        out = np.empty(2 * n, np.float32)
        got = int(lib().rb_read(self._h, _fp(out), 2 * n))
        return _to_complex(out[:got])

    @property
    def size(self) -> int:
        return int(lib().rb_size(self._h)) // 2

    def close(self):
        if self._h:
            lib().rb_destroy(self._h)
            self._h = None


class SamplePipeTx:
    """UDP IQ transmitter (native thread-free sender)."""

    def __init__(self, host: str, port: int):
        self._h = lib().pipe_tx_create(host.encode(), port)

    def send(self, x: np.ndarray) -> int:
        f = _to_floats(x)
        return int(lib().pipe_tx_send(self._h, _fp(f), len(f))) // 2

    def close(self):
        if self._h:
            lib().pipe_tx_destroy(self._h)
            self._h = None


class SamplePipeRx:
    """UDP IQ receiver: native background thread fills a native ring."""

    def __init__(self, port: int, capacity: int = 1 << 20):
        self._h = lib().pipe_rx_create(port, 2 * capacity)

    def read(self, n: int, timeout_ms: int = 1000) -> np.ndarray:
        out = np.empty(2 * n, np.float32)
        got = int(lib().pipe_rx_read(self._h, _fp(out), 2 * n, timeout_ms))
        return _to_complex(out[:got])

    def close(self):
        if self._h:
            lib().pipe_rx_destroy(self._h)
            self._h = None


class TtiClock:
    """Steady ticker with atomic TTI counter + blocking wait."""

    def __init__(self, interval_us: int = 1000):
        self._h = lib().ttic_create(interval_us)

    @property
    def now(self) -> int:
        return int(lib().ttic_now(self._h))

    def wait(self, tti: int, timeout_ms: int = 1000) -> int:
        return int(lib().ttic_wait(self._h, tti, timeout_ms))

    def close(self):
        if self._h:
            lib().ttic_destroy(self._h)
            self._h = None
