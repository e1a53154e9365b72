"""Carrier-frequency-offset correction.

Reference behavior: lib/src/phy/sync/cfo.c (srsran_cfo_correct: complex
exponential multiply, :96).  Correction is one elementwise complex multiply
with a phase ramp.  Ported: `cfo_correct`, which `UeUl.encode_pusch` uses
for a non-zero CFO; the CP-based estimator is ROADMAP queue A item 7.
"""

from __future__ import annotations

import math

import torch

from ..._device import as_tensor


def cfo_correct(x, cfo, fft_size: int, n0=0, device=None):
    """x[..., L] * exp(-j*2*pi*cfo*(n0 + n)/fft_size).

    cfo is in subcarrier-spacing units (as everywhere in the C library), a
    number or a tensor of batch shape; n0 is the absolute sample index of
    x[..., 0] (keeps phase continuous across block boundaries in streaming
    use).  The phase is formed in complex64 as the JAX package forms it.
    """
    x = as_tensor(x, device)
    n = torch.arange(x.shape[-1], device=x.device)
    cfo = torch.as_tensor(cfo, device=x.device)
    phase = (-2j * math.pi * cfo[..., None].to(torch.complex64)) * (n + n0) / fft_size
    return x * torch.exp(phase)
