"""AWGN channel (ch_awgn.c equivalent).

Reference behavior: lib/src/phy/channel/ch_awgn.c: complex Gaussian noise at
a configured SNR or N0.  The draws come from an explicit `torch.Generator`
on the tensor's device.
"""

from __future__ import annotations

import torch


def awgn_power(gen: torch.Generator, x: torch.Tensor, n0) -> torch.Tensor:
    """Add complex Gaussian noise with total noise power n0 per sample."""
    std = torch.sqrt(torch.as_tensor(n0, dtype=torch.float32, device=x.device) / 2)
    n = torch.randn((2,) + tuple(x.shape), generator=gen, device=x.device)
    return x + std * torch.complex(n[0], n[1])


def awgn(gen: torch.Generator, x: torch.Tensor, snr_db: float) -> torch.Tensor:
    """Add noise at an SNR relative to the measured mean power of all of x
    (one power for the whole tensor, not one per row)."""
    p = torch.mean(torch.abs(x) ** 2)
    return awgn_power(gen, x, p / (10.0 ** (snr_db / 10.0)))
