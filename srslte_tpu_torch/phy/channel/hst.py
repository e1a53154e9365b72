"""High-speed-train Doppler trajectory (hst.c equivalent, 36.101 B.3).

Reference behavior: lib/src/phy/channel/hst.c: time-varying Doppler shift
f_s(t) = f_d * cos(theta(t)) for the train passing a trackside eNB:
cos(theta) follows the three-segment geometry of 36.101 B.3.2/B.3A.

The trajectory and its phase are host numpy in float64, the same
expressions as the JAX package's, so the complex64 factor that `apply_hst`
uploads equals the reference's bit for bit.  It costs a host pass over the
stream and one upload of 8 bytes per sample.
"""

from __future__ import annotations

import numpy as np
import torch


def hst_cos_theta(t, ds: float = 300.0, d_min: float = 2.0, v: float = 300.0,
                  period_s: float | None = None):
    """cos(theta(t)) per 36.101 B.3.2 (scenario 1/3 geometry).

    ds: eNB distance from the track start [m]; d_min: track offset [m];
    v: speed [km/h].  Periodic with 2*ds/v_ms.
    """
    v_ms = v / 3.6
    t = np.asarray(t, np.float64)
    period = period_s if period_s is not None else 2 * ds / v_ms
    tt = np.mod(t, period)
    half = ds / v_ms
    x1 = ds / 2 - v_ms * tt  # first pass
    x2 = -1.5 * ds + v_ms * tt  # second segment
    c1 = x1 / np.sqrt(d_min**2 + x1**2)
    c2 = x2 / np.sqrt(d_min**2 + x2**2)
    return np.where(tt <= half, c1, c2)


def hst_doppler(t, f_d: float, **kw):
    """Instantaneous Doppler shift [Hz] at times t."""
    return f_d * hst_cos_theta(t, **kw)


def apply_hst(x: torch.Tensor, srate: int, f_d: float, t0: float = 0.0, **kw) -> torch.Tensor:
    """Apply the HST time-varying frequency shift to samples x [..., n]."""
    n = x.shape[-1]
    t = t0 + np.arange(n) / srate
    # integrate the instantaneous Doppler for the phase trajectory
    phase = 2 * np.pi * np.cumsum(hst_doppler(t, f_d, **kw)) / srate
    return x * torch.as_tensor(np.exp(1j * phase).astype(np.complex64)).to(x.device)
