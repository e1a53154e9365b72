"""OFDM modulation/demodulation with cyclic prefix.

Reference behavior: lib/src/phy/dft/ofdm.c (srsran_ofdm_tx_sf / rx_sf), incl.
the RE<->FFT-bin mirror mapping (ofdm_tx_slot / ofdm_rx_slot), unnormalized
FFTW convention with optional 1/sqrt(N) normalization and the DC carrier skip.

A subframe is one batched FFT of shape [..., nsymb_sf, N] (``torch.fft``) plus
two static gathers: CP insert / strip are index maps built once per bucket.
Everything vectorizes over arbitrary leading batch dims (subframes, carriers,
antennas).  The per-symbol fractional frequency shift of the uplink
(``freq_shift``) is not ported yet (ROADMAP queue A item 9).
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
    each way; `UeDl` and `EnbDl` use it.
    """

    params: OfdmParams
    normalize: bool = False
    freq_shift: float = 0.0  # in units of subcarrier spacing; only 0.0 is ported
    keep_dc: bool = False

    def __post_init__(self):
        if self.freq_shift != 0.0:
            raise NotImplementedError(
                "Ofdm.freq_shift (UL half-subcarrier shift) is not ported yet "
                "(ROADMAP queue A item 9: UL chain)")

    # -- static tables ------------------------------------------------------
    @property
    def dc(self) -> int:
        return 0 if self.keep_dc else 1

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
        return flat[..., self._idx("_cp_insert_idx", grid.device)]

    def rx_sf(self, samples, device=None):
        """Time samples [..., sf_len] -> RE grid [..., nsymb_sf, nof_re]."""
        samples = as_tensor(samples, device).to(torch.complex64)
        n = self.params.symbol_sz
        sym = samples[..., self._idx("_cp_strip_idx", samples.device)]
        bins = torch.fft.fft(sym, dim=-1)  # [..., nsymb_sf, N]
        if self.normalize:
            bins = bins * float(1.0 / np.sqrt(n))
        return bins[..., self._idx("_re_to_bin", samples.device)]

