# Frozen copy of srslte_tpu_torch/_device.py at commit e4337f4, unchanged but for this line.
"""Device selection and the cache of static tables.

Every entry point of the package takes ``device=None``.  ``None`` means the
CUDA device, and raises when there is none: the package has no silent CPU
path.  Tests pass ``device="cpu"`` explicitly.  A ``torch.Tensor`` argument
keeps the device it already has when ``device`` is ``None``.

Static numpy tables (gather indices, CRC matrices, masks) are uploaded once
per (key, device) and kept.  A table's key is the values that determine it
(a cell, a PRB mask, a code length), never a processor object or an RNTI, so
the processors of two UEs with the same grant share one entry.  Tables that
do depend on the UE (scrambling sequences, whose seed carries the RNTI, and
the gathers of a UE-specific PDCCH search space) go through `sequence`
instead: the same upload, kept in a cache of at most `SEQUENCE_BYTES` that
drops the least recently used, so attaching more UEs cannot grow it without
bound.

A CUDA graph (`utils.jit`) replays the addresses its capture read, so no
table may be uploaded while a graph is captured (`_upload` raises: the
warm-up before the capture fills the cache), the graph holds every table and
sequence its capture read (`recording`), and `sequence` never drops one that
a live graph has pinned.
"""

from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict

import numpy as np
import torch

_TABLES: dict = {}
_SEQUENCES: OrderedDict = OrderedDict()
SEQUENCE_BYTES = 256 * 2**20
_PINS: dict = {}
_LOCAL = threading.local()


def default_device() -> torch.device:
    """The CUDA device; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "srslte_tpu_torch runs on a CUDA device and torch.cuda.is_available() "
            "is False; pass device='cpu' explicitly to run on the host")
    return torch.device("cuda")


def resolve(device=None) -> torch.device:
    """`device` as a torch.device; a CUDA device always with its index, so
    that "cuda" and "cuda:0" name one cache entry."""
    device = default_device() if device is None else torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """Tensor of ``x`` on ``device``.

    With ``device=None`` a tensor stays where it is and host data (numpy,
    lists) goes to the default device.
    """
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(resolve(device))
    else:
        device = resolve(device)
        _check_not_capturing(device, "host data")
        x = torch.as_tensor(np.array(x)).to(device)
    return x if dtype is None else x.to(dtype)


def _check_not_capturing(device, what):
    if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} uploaded while a CUDA graph is captured: a graph "
                           "must read only tensors already on the device")


def take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[idx] along dim 0 for an integer tensor idx of any shape.  A 0-d
    tensor used as an index is read back to the host (as a Python int), so
    the index goes in as a 1-d tensor."""
    return t[idx.reshape(-1)].reshape(idx.shape + t.shape[1:])


def _upload(key, build, device, dtype) -> torch.Tensor:
    _check_not_capturing(device, f"table {key!r}")
    t = torch.as_tensor(np.ascontiguousarray(build())).to(device)
    return t if dtype is None else t.to(dtype)


@contextlib.contextmanager
def recording():
    """Within: every `table` and `sequence` read is appended to the list
    yielded, as (kind, cache key, tensor)."""
    _LOCAL.used = used = []
    try:
        yield used
    finally:
        _LOCAL.used = None


def _record(kind, k, t):
    used = getattr(_LOCAL, "used", None)
    if used is not None:
        used.append((kind, k, t))
    return t


def pin(keys):
    """Keep the sequences of these cache keys while a graph holds them."""
    for k in keys:
        _PINS[k] = _PINS.get(k, 0) + 1


def unpin(keys):
    for k in keys:
        _PINS[k] -= 1
        if not _PINS[k]:
            del _PINS[k]


def table(key, device, build, dtype=None) -> torch.Tensor:
    """``build()`` (numpy array) uploaded once per (key, device, dtype)."""
    device = resolve(device)
    k = (key, str(device), dtype)
    t = _TABLES.get(k)
    if t is None:
        t = _TABLES[k] = _upload(key, build, device, dtype)
    return _record("table", k, t)


def sequence(key, device, build, dtype=None) -> torch.Tensor:
    """`table` for a table that depends on the UE: kept among the most
    recently used, at most `SEQUENCE_BYTES` in all."""
    device = resolve(device)
    k = (key, str(device), dtype)
    t = _SEQUENCES.get(k)
    if t is not None:
        _SEQUENCES.move_to_end(k)
        return _record("sequence", k, t)
    t = _SEQUENCES[k] = _upload(key, build, device, dtype)
    total = sum(_nbytes(v) for v in _SEQUENCES.values())
    # the least recently used first, past the pinned ones and the new one
    for old in [o for o in _SEQUENCES if o not in _PINS and o != k]:
        if total <= SEQUENCE_BYTES:
            break
        total -= _nbytes(_SEQUENCES.pop(old))
    return _record("sequence", k, t)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()
