"""SC-FDMA transform precoding (36.211 §5.3.3, dft_precoding.c equivalent).

Reference behavior: lib/src/phy/dft/dft_precoding.c — forward DFT of size
M = n_prb*12 per SC-FDMA data symbol with 1/sqrt(M) normalization, and the
valid-PRB rule (prime factors 2, 3, 5 only, srsran_dft_precoding_valid_prb).

One batched `torch.fft` over [..., nsymb, M]: the mixed-radix sizes need no
per-size plan objects.
"""

from __future__ import annotations

import numpy as np
import torch

from ..._device import as_tensor


def valid_prb(n_prb: int) -> bool:
    """True if n_prb factors into 2^a * 3^b * 5^c (dft_precoding.c:39)."""
    n = n_prb
    for p in (2, 3, 5):
        while n % p == 0:
            n //= p
    return n == 1


def dft_precode(x, device=None):
    """x [..., M] modulation symbols -> frequency-domain [..., M]."""
    x = as_tensor(x, device).to(torch.complex64)
    m = x.shape[-1]
    return torch.fft.fft(x, dim=-1) * float(1.0 / np.sqrt(m))


def dft_deprecode(y, device=None):
    """Inverse transform precoding: [..., M] -> [..., M]."""
    y = as_tensor(y, device).to(torch.complex64)
    m = y.shape[-1]
    return torch.fft.ifft(y, dim=-1) * float(np.sqrt(m))
