"""Carrier-frequency-offset estimation and correction.

Reference behavior: lib/src/phy/sync/cfo.c (srsran_cfo_correct: complex
exponential multiply, :96) and cp.c (CP-based estimator: correlate each CP
with the symbol tail one FFT-length later).  Correction is one elementwise
complex multiply with a phase ramp; the CP estimator is one gather of the CP
and tail pairs of all symbols of a subframe and one reduction.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import OfdmParams


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


@functools.lru_cache(maxsize=None)
def _cp_pairs(params: OfdmParams) -> np.ndarray:
    """[nsym, cp_min] sample indices of the last cp_min samples of every CP
    of a subframe (aligned with the symbol tail one FFT length later)."""
    n = params.symbol_sz
    offs, cps, pos = [], [], 0
    for cp in params.cp_lens_slot() * 2:
        offs.append(pos)
        cps.append(cp)
        pos += cp + n
    cp_min = min(cps)
    return np.stack([o + c - cp_min + np.arange(cp_min) for o, c in zip(offs, cps)])


def cfo_estimate_cp(samples, params: OfdmParams, device=None):
    """CP-based CFO estimate from one subframe [..., sf_len] -> cfo [...].

    For every symbol, corr = sum_cp conj(x[n]) * x[n + N]; the CP repeats the
    symbol tail, so arg(corr) = 2*pi*cfo.  Averaged over all symbols of the
    subframe (cp.c behavior at subframe granularity).
    """
    samples = as_tensor(samples, device)
    idx = table(("cfo_cp", params), samples.device,
                lambda: _cp_pairs(params).astype(np.int64))
    a = samples[..., idx]  # [..., nsym, cp_min]
    b = samples[..., idx + params.symbol_sz]
    corr = torch.sum(torch.conj(a) * b, dim=(-1, -2))
    return torch.angle(corr) / (2 * math.pi)
