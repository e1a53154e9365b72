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
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

_TABLES: dict = {}
_SEQUENCES: OrderedDict = OrderedDict()
SEQUENCE_BYTES = 256 * 2**20


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
        x = torch.as_tensor(np.array(x)).to(resolve(device))
    return x if dtype is None else x.to(dtype)


def _upload(build, device, dtype) -> torch.Tensor:
    t = torch.as_tensor(np.ascontiguousarray(build())).to(device)
    return t if dtype is None else t.to(dtype)


def table(key, device, build, dtype=None) -> torch.Tensor:
    """``build()`` (numpy array) uploaded once per (key, device, dtype)."""
    device = resolve(device)
    k = (key, str(device), dtype)
    t = _TABLES.get(k)
    if t is None:
        t = _TABLES[k] = _upload(build, device, dtype)
    return t


def sequence(key, device, build, dtype=None) -> torch.Tensor:
    """`table` for a table that depends on the UE: kept among the most
    recently used, at most `SEQUENCE_BYTES` in all."""
    device = resolve(device)
    k = (key, str(device), dtype)
    t = _SEQUENCES.get(k)
    if t is not None:
        _SEQUENCES.move_to_end(k)
        return t
    t = _SEQUENCES[k] = _upload(build, device, dtype)
    total = sum(v.numel() * v.element_size() for v in _SEQUENCES.values())
    while total > SEQUENCE_BYTES and len(_SEQUENCES) > 1:
        _, old = _SEQUENCES.popitem(last=False)
        total -= old.numel() * old.element_size()
    return t
