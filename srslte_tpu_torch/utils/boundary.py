"""Host <-> device boundary of complex arrays.

The counterpart of the JAX package's ``utils/boundary.py``.  PyTorch moves
complex64 across the boundary as it is, so both directions are one copy.
"""

from __future__ import annotations

import numpy as np
import torch

from .._device import resolve


def to_device_complex(x, device=None) -> torch.Tensor:
    """Host complex array -> complex64 tensor on `device` (None: the CUDA
    device)."""
    return torch.from_numpy(np.ascontiguousarray(x, dtype=np.complex64)).to(resolve(device))


def from_device_complex(x: torch.Tensor) -> np.ndarray:
    """Device tensor -> host complex64 ndarray."""
    return x.detach().to(torch.complex64).cpu().numpy()
