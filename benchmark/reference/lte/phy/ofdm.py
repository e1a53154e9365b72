# Frozen copy of srslte_tpu_torch/phy/ofdm.py at commit e4337f4, unchanged but for this line.
"""OFDM modulation/demodulation with cyclic prefix.

Reference behavior: lib/src/phy/dft/ofdm.c (srsran_ofdm_tx_sf / rx_sf), incl.
the RE<->FFT-bin mirror mapping (ofdm_tx_slot / ofdm_rx_slot), unnormalized
FFTW convention with optional 1/sqrt(N) normalization, the DC carrier skip
(dc=1 unless a fractional frequency shift is configured), and the
per-symbol fractional frequency shift exp(j*2*pi*(t-cp)/N * f) used for the
UL half-subcarrier offset (srsran_ofdm_set_freq_shift, ofdm.c:334-362).

A subframe is one batched FFT of shape [..., nsymb_sf, N] (``torch.fft``) plus
two static gathers: CP insert / strip are index maps built once per bucket.
Everything vectorizes over arbitrary leading batch dims (subframes, carriers,
antennas).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_tensor, table
from .common.params import OfdmParams


@dataclass(frozen=True)
class Ofdm:
    """Static-shape OFDM modem for one (n_prb, cp) bucket.

    normalize=False matches the C library's DL convention (enb_dl.c:57,
    ue_dl.c:92): forward FFT and backward FFT are both unnormalized (FFTW),
    so a tx->rx round trip scales by N.  normalize=True applies 1/sqrt(N)
    each way; `UeDl`, `EnbDl`, `UeUl` and `EnbUl` use it.
    """

    params: OfdmParams
    normalize: bool = False
    freq_shift: float = 0.0  # in units of subcarrier spacing (UL: +0.5 tx / -0.5 rx)
    keep_dc: bool = False

    # -- static tables ------------------------------------------------------
    @property
    def dc(self) -> int:
        return 0 if (self.keep_dc or self.freq_shift != 0.0) else 1

    @functools.cached_property
    def _cp_lens_sf(self) -> np.ndarray:
        return np.array(self.params.cp_lens_slot() * 2, dtype=np.int32)

    @functools.cached_property
    def _cp_insert_idx(self) -> np.ndarray:
        """[sf_len] -> index into flattened [nsymb_sf*N] IFFT output."""
        p = self.params
        idx = np.empty(p.sf_len, dtype=np.int32)
        pos = 0
        for i, cp in enumerate(self._cp_lens_sf):
            n = p.symbol_sz
            t = np.arange(cp + n)
            idx[pos : pos + cp + n] = i * n + (t - cp) % n
            pos += cp + n
        assert pos == p.sf_len
        return idx

    @functools.cached_property
    def _cp_strip_idx(self) -> np.ndarray:
        """[nsymb_sf, N] -> index into input samples [sf_len] (skips CPs)."""
        p = self.params
        offs = np.array(p.symbol_offsets_slot(), dtype=np.int64)
        starts = np.concatenate([offs, offs + p.slot_len]) + self._cp_lens_sf
        return (starts[:, None] + np.arange(p.symbol_sz)[None, :]).astype(np.int32)

    @functools.cached_property
    def _shift_buffer(self) -> np.ndarray | None:
        """Per-sample fractional frequency shift (ofdm.c:347-356), phases in
        float64 on the host, rounded once to complex64."""
        if self.freq_shift == 0.0:
            return None
        p = self.params
        buf = np.empty(p.sf_len, dtype=np.complex64)
        pos = 0
        for cp in self._cp_lens_sf:
            n = p.symbol_sz
            t = np.arange(cp + n, dtype=np.float64)
            buf[pos : pos + cp + n] = np.exp(2j * np.pi * (t - cp) * self.freq_shift / n)
            pos += cp + n
        return buf

    def _shift(self, device) -> torch.Tensor | None:
        if self.freq_shift == 0.0:
            return None
        return table(("ofdm", self, "_shift_buffer"), device, lambda: self._shift_buffer)

    @functools.cached_property
    def _re_to_bin(self) -> np.ndarray:
        """[nof_re] -> FFT bin index (mirror map, ofdm_tx_slot)."""
        p, dc = self.params, self.dc
        half = p.nof_re // 2
        lo = np.arange(p.symbol_sz - half, p.symbol_sz)  # grid[0:half] -> top bins
        hi = np.arange(dc, dc + half)  # grid[half:] -> bins dc..
        return np.concatenate([lo, hi]).astype(np.int32)

    def _idx(self, name: str, device) -> torch.Tensor:
        return table(("ofdm", self, name), device,
                     lambda: getattr(self, name).astype(np.int64))

    # -- data path ----------------------------------------------------------
    def tx_sf(self, grid, device=None):
        """RE grid [..., nsymb_sf, nof_re] -> time samples [..., sf_len]."""
        grid = as_tensor(grid, device).to(torch.complex64)
        p = self.params
        n = p.symbol_sz
        bins = torch.zeros(grid.shape[:-1] + (n,), dtype=torch.complex64,
                           device=grid.device)
        bins[..., self._idx("_re_to_bin", grid.device)] = grid
        # unnormalized backward FFT (FFTW convention): ifft * N
        scale = float(np.sqrt(np.float32(n))) if self.normalize else float(n)
        sym = torch.fft.ifft(bins, dim=-1) * scale
        flat = sym.reshape(sym.shape[:-2] + (p.nsymb_sf * n,))
        out = flat[..., self._idx("_cp_insert_idx", grid.device)]
        shift = self._shift(grid.device)
        return out if shift is None else out * shift

    def rx_sf(self, samples, device=None):
        """Time samples [..., sf_len] -> RE grid [..., nsymb_sf, nof_re]."""
        samples = as_tensor(samples, device).to(torch.complex64)
        n = self.params.symbol_sz
        shift = self._shift(samples.device)
        if shift is not None:
            samples = samples * shift
        sym = samples[..., self._idx("_cp_strip_idx", samples.device)]
        bins = torch.fft.fft(sym, dim=-1)  # [..., nsymb_sf, N]
        if self.normalize:
            bins = bins * float(1.0 / np.sqrt(n))
        return bins[..., self._idx("_re_to_bin", samples.device)]


def ofdm_tx(params: OfdmParams, grid, device=None, **kw):
    """`Ofdm(params, **kw).tx_sf(grid)` in one call."""
    return Ofdm(params, **kw).tx_sf(grid, device)


def ofdm_rx(params: OfdmParams, samples, device=None, **kw):
    """`Ofdm(params, **kw).rx_sf(samples)` in one call."""
    return Ofdm(params, **kw).rx_sf(samples, device)
