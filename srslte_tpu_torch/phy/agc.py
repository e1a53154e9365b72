"""Software AGC (agc.c equivalent).

Reference behavior: lib/src/phy/agc/agc.c: per-frame RSSI measurement with
exponential tracking toward a target amplitude (srsran_agc_process:217),
gain clamped to [min, max].

The work is split three ways: every frame's raw RMS in one batched reduction
on the tensor's device; the clamped gain recursion over the [B, n_frames]
floats in numpy float32 on the host, in the JAX package's order of
operations (one copy to the host per call: srsRAN's gain loop is host code
too); one multiply by the per-frame gains on the device.  The one deviation
from the JAX package: the RSSI of a frame is g * RMS(frame), where the
reference measures RMS(frame * g); the two differ by float32 rounding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Agc:
    target: float = 0.3  # target RMS amplitude
    bandwidth: float = 0.7  # tracking speed (0..1]
    min_gain_db: float = -20.0
    max_gain_db: float = 40.0

    def _gains(self, raw_rms: np.ndarray, g0_db: float = 0.0):
        """The recursion over frames on the host: raw_rms [B, n] float32 ->
        (gain in dB applied to each frame [B, n], RSSI after that gain [B, n]).

        The gain applied to frame i is the state before observing it (the
        C library updates the hardware gain for the next frame the same
        way)."""
        f32 = np.float32
        raw_rms = np.asarray(raw_rms, f32)
        g_db = np.full(raw_rms.shape[0], g0_db, f32)
        gains, rssi = np.empty_like(raw_rms), np.empty_like(raw_rms)
        for i in range(raw_rms.shape[1]):
            g = f32(10.0) ** (g_db / f32(20.0))
            r = g * raw_rms[:, i]
            err_db = f32(20.0) * np.log10(np.maximum(f32(self.target) / np.maximum(r, f32(1e-9)),
                                                     f32(1e-9)))
            gains[:, i], rssi[:, i] = g_db, r
            g_db = np.clip(g_db + f32(self.bandwidth) * err_db, f32(self.min_gain_db),
                           f32(self.max_gain_db)).astype(f32)
        return gains, rssi

    def process(self, x: torch.Tensor, frame_len: int, g0_db: float = 0.0):
        """x [n] (or [B, n]) -> (y scaled, gain_db [B, n_frames], rssi
        [B, n_frames]) with the JAX package's return shapes; gains and RSSI
        are float32 tensors on x's device."""
        n = x.shape[-1] // frame_len
        frames = x[..., : n * frame_len].reshape(-1, n, frame_len)
        raw = torch.sqrt(torch.mean(torch.abs(frames) ** 2, dim=-1))
        gains, rssi = self._gains(raw.cpu().numpy(), g0_db)
        lin = torch.as_tensor(np.float32(10.0) ** (gains / np.float32(20.0))).to(x.device)
        y = (frames * lin[..., None]).reshape(x.shape[:-1] + (-1,))
        y = y[0] if y.shape[0] == 1 and x.ndim == 1 else y
        return y, torch.as_tensor(gains).to(x.device), torch.as_tensor(rssi).to(x.device)
