"""3GPP multipath fading emulator: EPA/EVA/ETU with Doppler (fading.c).

Reference behavior: lib/src/phy/channel/fading.c: tap tables (:33-35, the
3GPP 36.101/36.104 Annex B.2 profiles), Rayleigh tap processes with Doppler,
FFT-domain convolution per block (:111,165).

The tap gains follow the Jakes sum-of-sinusoids model evaluated for all
blocks at once; the convolution is overlap-save: the padded stream is cut
into [n_blocks, nfft] blocks at a stride of `block` samples with
`Tensor.unfold` (a view, no index), and one batched FFT, one multiply by the
per-block frequency response and one inverse FFT apply the channel to an
arbitrarily long stream.  Fractional tap delays are exact (frequency-domain
phase ramps), where the C library rounds to the sample grid.

The Jakes parameters come from `np.random.default_rng(seed)` on the host and
the gains are formed in float32 as the JAX package forms them, so the two
packages produce the same channel from the same seed.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import table

# 3GPP TS 36.101/36.104 Annex B.2.1 tap models: (delay ns, power dB)
PROFILES = {
    "epa": ([0, 30, 70, 90, 110, 190, 410],
            [0.0, -1.0, -2.0, -3.0, -8.0, -17.2, -20.8]),
    "eva": ([0, 30, 150, 310, 370, 710, 1090, 1730, 2510],
            [0.0, -1.5, -1.4, -3.6, -0.6, -9.1, -7.0, -12.0, -16.9]),
    "etu": ([0, 50, 120, 200, 230, 500, 1600, 2300, 5000],
            [-1.0, -1.0, -1.0, 0.0, 0.0, 0.0, -3.0, -5.0, -7.0]),
    "none": ([0], [0.0]),  # single LOS tap (for delay-only tests)
}

N_SINUSOIDS = 16


@dataclass(frozen=True)
class FadingChannel:
    """Block fading emulator for one (profile, doppler, srate) bucket."""

    profile: str
    doppler_hz: float
    srate: int
    block: int = 2048  # processing block (output samples per FFT)
    seed: int = 0

    @functools.cached_property
    def _taps(self):
        delays_ns, powers_db = PROFILES[self.profile]
        d = np.asarray(delays_ns, np.float64) * 1e-9 * self.srate  # samples
        p = 10 ** (np.asarray(powers_db, np.float64) / 10)
        p = p / p.sum()
        return d, np.sqrt(p)

    @property
    def halo(self) -> int:
        """Overlap-save halo covering the maximum delay spread."""
        d, _ = self._taps
        return int(np.ceil(d.max())) + 1

    @property
    def nfft(self) -> int:
        return int(2 ** np.ceil(np.log2(self.block + self.halo)))

    @functools.cached_property
    def _jakes(self):
        """Per-tap sum-of-sinusoids parameters (host RNG, static)."""
        rng = np.random.default_rng(self.seed)
        n_taps = len(self._taps[0])
        theta = rng.uniform(0, 2 * np.pi, (n_taps, N_SINUSOIDS))
        phi = rng.uniform(0, 2 * np.pi, (n_taps, N_SINUSOIDS))
        return theta, phi

    def _ramp(self) -> np.ndarray:
        """[taps, nfft] complex64: each tap's delay as a phase ramp."""
        d, _ = self._taps
        f = np.fft.fftfreq(self.nfft)
        return np.exp(-2j * np.pi * f[None, :] * d[:, None]).astype(np.complex64)

    def tap_gains(self, t: torch.Tensor) -> torch.Tensor:
        """Rayleigh tap gains at times t [n] (seconds, float32): [n, n_taps]
        complex64.  t * w + phi is formed in float32, as the JAX package
        (which runs without 64-bit floats) forms it."""
        theta, phi = self._jakes
        _, amp = self._taps
        dev = t.device
        f32 = torch.float32
        w = table(("jakes_w", self), dev,
                  lambda: 2 * np.pi * self.doppler_hz * np.cos(theta), f32)  # [taps, N]
        ph = table(("jakes_phi", self), dev, lambda: phi, f32)
        a = table(("tap_amp", self), dev, lambda: amp, f32)
        if self.doppler_hz == 0.0:
            # static channel: a fixed unit-variance complex gain per tap
            g = torch.polar(torch.ones_like(ph[:, 0]), ph[:, 0])[None, :].expand(t.shape[0], -1)
        else:
            arg = t.to(f32)[:, None, None] * w + ph
            g = torch.polar(torch.ones_like(arg), arg).mean(dim=-1) * float(np.sqrt(N_SINUSOIDS))
        return (g * a).to(torch.complex64)

    def __call__(self, x: torch.Tensor, t0: float = 0.0) -> torch.Tensor:
        """Apply the channel to x [n] -> y [n] (same length, causal).

        Quasi-static per block: tap gains are evaluated at each block center
        (fading.c interpolates coefficients per subframe similarly).
        """
        x = x.to(torch.complex64)
        n = x.shape[-1]
        L, P, nfft = self.block, self.halo, self.nfft
        nblk = -(-n // L)
        # P zeros of halo in front, then the stream padded so that the last
        # block of nfft samples at stride L is whole: nblk blocks
        tail = (nblk - 1) * L + nfft - P - n
        xp = torch.nn.functional.pad(torch.view_as_real(x), (0, 0, P, tail))
        blocks = torch.view_as_complex(xp).unfold(-1, nfft, L)  # [nblk, nfft]
        t = (np.arange(nblk) * L + L / 2) / self.srate + t0
        g = self.tap_gains(torch.as_tensor(t, dtype=torch.float32).to(x.device))  # [nblk, taps]
        ramp = table(("fading_ramp", self.profile, self.srate, nfft), x.device, self._ramp)
        h = g @ ramp  # [nblk, nfft]
        y = torch.fft.ifft(torch.fft.fft(blocks, dim=-1) * h, dim=-1)
        return y[:, P : P + L].reshape(-1)[:n]
