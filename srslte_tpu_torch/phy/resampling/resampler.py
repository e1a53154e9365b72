"""Sample-rate conversion (resampler.c / resample_arb.c / interp.c).

Reference behavior: lib/src/phy/resampling/resampler.c: FFT-domain integer
interpolation/decimation (used by radio.cc when the device rate differs from
the cell rate); interp.c linear interpolation helpers (used by chest).

Rational L/M resampling is one FFT -> spectral crop/pad -> IFFT over the
whole buffer (batched over leading dims), instead of the reference's
streaming polyphase loops.  Exact for bandlimited signals and cyclic
buffers; block edges see the usual FFT wraparound (callers keep a halo, as
the radio does with its resampler state).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..._device import table


def resample_fft(x: torch.Tensor, up: int, down: int) -> torch.Tensor:
    """Resample x [..., n] by rational factor up/down via spectral resize.

    n*up must be divisible by down.  Energy-preserving amplitude scaling.
    """
    n = x.shape[-1]
    m = n * up // down
    if m * down != n * up:
        raise ValueError(f"{n}*{up}/{down} is not an integer output length")
    xf = torch.fft.fft(x.to(torch.complex64), dim=-1)
    out = torch.zeros(x.shape[:-1] + (m,), dtype=xf.dtype, device=x.device)
    half = min(n, m) // 2
    out[..., :half] = xf[..., :half]
    if half:
        out[..., m - half :] = xf[..., n - half :]
    return (torch.fft.ifft(out, dim=-1) * (m / n)).to(torch.complex64)


def interp_linear_cf(x: torch.Tensor, ratio: int) -> torch.Tensor:
    """Linear interpolation by an integer factor (interp.c linear mode)."""
    n = x.shape[-1]
    xi = torch.arange(n * ratio, dtype=torch.int32, device=x.device) / ratio
    i0 = torch.floor(xi).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n - 1)
    frac = xi - i0
    return x[..., i0] * (1 - frac) + x[..., i1] * frac


# ---------------------------------------------------------------------------
# Arbitrary-ratio polyphase resampler (resample_arb.c)
# ---------------------------------------------------------------------------

ARB_N, ARB_M = 32, 8  # phases, taps (SRSRAN_RESAMPLE_ARB_N/_M)


@functools.lru_cache(maxsize=1)
def _arb_polyfilt() -> np.ndarray:
    """The C library's 32-phase x 8-tap bank (resample_arb.c
    srsran_resample_arb_polyfilt), from this package's own copy of the
    table."""
    path = os.path.join(os.path.dirname(__file__), "arb_polyfilt.npz")
    return np.load(path)["polyfilt"].astype(np.float32)


@functools.lru_cache(maxsize=64)
def _arb_plan(n_in: int, rate: float, interpolate: bool):
    """Precompute (window gather idx [n_out, M], pad mask, phase idx [n_out],
    frac).

    Mirrors the C library's streaming accumulator (resample_arb.c
    srsran_resample_arb_compute): output j is taken at accumulated phase
    j*step with step = N/rate; cnt_j input samples have been consumed when
    it is emitted, and its filter window is input[cnt_j - M : cnt_j] (zeros
    before the first sample).  Outputs run while cnt_j < n_in.
    """
    # The accumulator is stepped SEQUENTIALLY (float64) exactly like the
    # C library's loop rather than as the closed form j*step mod N: at
    # rational rates the phase lands on exact filter-bank boundaries and
    # the closed form rounds the other way, swapping whole phase rows.
    step = ARB_N / rate
    acc = 0.0
    cnt_i = 0
    cnts, idxs, fracs = [], [], []
    while cnt_i < n_in:
        i = int(acc)
        cnts.append(cnt_i)
        idxs.append(i)
        fracs.append(abs(acc - i))
        acc += step
        i = int(acc)
        while i >= ARB_N:
            acc -= ARB_N
            i -= ARB_N
            cnt_i += 1
    cnt = np.asarray(cnts, np.int64)
    idx = np.asarray(idxs, np.int32)
    frac = np.asarray(fracs, np.float32)
    n_out = len(cnts)
    win = cnt[:, None] - ARB_M + np.arange(ARB_M)[None, :]  # [n_out, M]
    pad = win < 0
    return (np.where(pad, 0, win).astype(np.int32), pad, idx,
            frac if interpolate else None)


@functools.lru_cache(maxsize=64)
def _arb_gather(n_in: int, rate: float, interpolate: bool):
    """The plan as (window index [n_out, M] with its padding pointed at a
    zero appended to the input, per-output filter taps [n_out, M])."""
    win, pad, idx, frac = _arb_plan(n_in, rate, interpolate)
    bank = _arb_polyfilt()
    taps = bank[idx]
    if frac is not None:
        nxt = bank[(idx + 1) % ARB_N]
        taps = taps + (nxt - taps) * frac[:, None]
    return np.where(pad, n_in, win).astype(np.int64), taps


def resample_arb(x: torch.Tensor, rate: float, interpolate: bool = False) -> torch.Tensor:
    """Arbitrary-ratio polyphase resampler (resample_arb.c equivalent).

    x [..., n_in] complex -> [..., n_out] at `rate` (out/in).  The C
    library's per-sample accumulator loop becomes a precomputed [n_out, M]
    window gather and a per-output filter row, contracted in one product;
    `interpolate` blends adjacent phase rows by the fractional phase exactly
    as the streaming loop does.
    """
    n_in = x.shape[-1]
    key = ("arb_plan", n_in, float(rate), interpolate)
    win = table(key + ("win",), x.device, lambda: _arb_gather(*key[1:])[0])
    taps = table(key + ("taps",), x.device, lambda: _arb_gather(*key[1:])[1], x.dtype)
    xz = torch.cat([x, torch.zeros(x.shape[:-1] + (1,), dtype=x.dtype, device=x.device)], -1)
    w = xz[..., win]  # [..., n_out, M], zero where the window is before the input
    return torch.einsum("...om,om->...o", w, taps)
