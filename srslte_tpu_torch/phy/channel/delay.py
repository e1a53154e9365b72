"""Fractional delay via a frequency-domain phase ramp (delay.c equivalent).

Reference behavior: lib/src/phy/channel/delay.c: a periodically drifting
sample delay applied in the frequency domain.
"""

from __future__ import annotations

import numpy as np
import torch

_TWO_PI = np.float32(2 * np.pi)


def fractional_delay(x: torch.Tensor, delay_samples) -> torch.Tensor:
    """Delay x [..., n] by a (possibly fractional) sample count, cyclically
    over the last axis.  The ramp is formed in float32 as the JAX package
    forms it: phase = (-2 pi f) * delay."""
    n = x.shape[-1]
    f = torch.fft.fftfreq(n, device=x.device)
    d = torch.as_tensor(delay_samples, dtype=torch.float32, device=x.device)
    ramp = torch.polar(torch.ones_like(f), (f * -_TWO_PI) * d)
    return torch.fft.ifft(torch.fft.fft(x, dim=-1) * ramp, dim=-1).to(x.dtype)


def delay_drift(t_s, period_s: float, max_delay_us: float, srate: int):
    """Triangular delay trajectory (delay.c semantics): samples at time t
    (host numpy)."""
    phase = (t_s % period_s) / period_s
    tri = 2 * np.minimum(phase, 1 - phase)
    return tri * max_delay_us * 1e-6 * srate
