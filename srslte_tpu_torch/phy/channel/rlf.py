"""Radio-link-failure burst generator (rlf.c equivalent).

Reference behavior: lib/src/phy/channel/rlf.c: periodically zeroes the
signal for t_off out of every t_on + t_off milliseconds (fault injection for
radio-link-monitoring tests).
"""

from __future__ import annotations

import numpy as np
import torch

from ..._device import resolve


def rlf_mask(n: int, srate: int, t_on_ms: float, t_off_ms: float, t0_s: float = 0.0,
             device=None) -> torch.Tensor:
    """[n] float32 mask: 1 during on-periods, 0 during the off bursts.

    The time axis is float32 and the remainder is an exact fmod with the
    sign rule of `jnp.mod`, as in the JAX package, so that the mask is equal
    to the reference's sample for sample, burst edges included."""
    dev = resolve(device)
    t = (torch.arange(n, dtype=torch.int32, device=dev) / srate + np.float32(t0_s)) \
        * np.float32(1e3)
    period = torch.tensor(t_on_ms + t_off_ms, dtype=torch.float32, device=dev)
    r = torch.fmod(t, period)
    r = torch.where((r != 0) & ((r < 0) != (period < 0)), r + period, r)
    return (r < np.float32(t_on_ms)).to(torch.float32)
