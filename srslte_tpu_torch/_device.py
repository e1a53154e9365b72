"""Device selection and the cache of static tables.

Every entry point of the package takes ``device=None``.  ``None`` means the
CUDA device, and raises when there is none: the package has no silent CPU
path.  Tests pass ``device="cpu"`` explicitly.  A ``torch.Tensor`` argument
keeps the device it already has when ``device`` is ``None``.

Static numpy tables (gather indices, CRC matrices, scrambling sequences) are
uploaded once per (key, device) and kept.
"""

from __future__ import annotations

import numpy as np
import torch

_TABLES: dict = {}


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


def table(key, device, build, dtype=None) -> torch.Tensor:
    """``build()`` (numpy array) uploaded once per (key, device, dtype)."""
    device = resolve(device)
    k = (key, str(device), dtype)
    t = _TABLES.get(k)
    if t is None:
        t = torch.as_tensor(np.ascontiguousarray(build())).to(device)
        if dtype is not None:
            t = t.to(dtype)
        _TABLES[k] = t
    return t
