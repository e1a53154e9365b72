"""CRS-based downlink synchronization/finder (refsignal_dl_sync.c).

Reference behavior: lib/src/phy/sync/refsignal_dl_sync.c: generate the
time-domain CRS-only signal for a cell hypothesis, cross-correlate it
against a capture (srsran_refsignal_dl_sync_find_peak:301), report the
peak offset, a peak-to-RMS metric, and the CFO from the phase rotation
between the two slots' correlations (srsran_refsignal_dl_sync_run).

The correlation is one FFT-domain product over the whole capture.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..._device import as_tensor, table
from ..chest.refsignal_dl import put_crs
from ..common.params import Cell
from ..ofdm import Ofdm
from .sync import window_slice


@functools.lru_cache(maxsize=None)
def crs_time_signature(cell: Cell, sf_idx: int) -> np.ndarray:
    """[sf_len] time-domain CRS-only subframe (port 0), built on the host."""
    o = cell.ofdm
    grid = torch.zeros((o.nsymb_sf, o.nof_re), dtype=torch.complex64)
    grid = put_crs(grid, cell, sf_idx, 0, device="cpu")
    return Ofdm(o, normalize=True).tx_sf(grid).numpy()


def refsignal_dl_sync_find(samples, cell: Cell, sf_idx: int = 0, device=None):
    """Correlate one subframe signature over the capture [n].

    -> (offset, metric, cfo_hz_norm) on the host: `metric` is |peak| / RMS
    of the correlation (the C library's peak detection); `cfo_hz_norm` is
    the CFO as a fraction of subcarrier spacing, estimated from the
    slot-half phase rotation of the correlation at the peak.
    """
    samples = as_tensor(samples, device).to(torch.complex64)
    dev = samples.device
    sig = table(("crs_signature", cell, sf_idx), dev, lambda: crs_time_signature(cell, sf_idx))
    n = samples.shape[-1]
    m = sig.shape[-1]
    size = int(2 ** np.ceil(np.log2(n + m)))
    fx = torch.fft.fft(samples, n=size)
    fs = torch.fft.fft(sig, n=size)
    corr = torch.fft.ifft(fx * torch.conj(fs), n=size)[: n - m + 1]
    mag = torch.abs(corr)
    peak = torch.argmax(mag)
    rms = torch.sqrt(torch.mean(mag**2))
    metric = mag[peak] / torch.clamp(rms, min=1e-12)
    # CFO: correlate each slot half separately at the peak position
    half = m // 2
    seg = window_slice(samples, peak, m)
    c0 = torch.sum(torch.conj(sig[:half]) * seg[:half])
    c1 = torch.sum(torch.conj(sig[half:]) * seg[half:])
    # the two slot-half correlation centers sit half a subframe apart
    # (7.5 symbol durations): phase = 2*pi * cfo_norm * 7.5, so the
    # unambiguous range is |cfo_norm| < 1/15 of the subcarrier spacing,
    # the same pull-in as the C library's CP-based fine CFO stage
    phase = torch.angle(c1 * torch.conj(c0))
    cfo_norm = phase / (2 * math.pi * 7.5)
    return int(peak), float(metric), float(cfo_norm)


def cell_find(samples, n_prb: int, cell_ids, sf_idx: int = 0,
              threshold: float = 6.0, device=None):
    """Try a set of cell-id hypotheses; return (cell_id, offset, metric)
    of the best above threshold, else None (dl_sync cell-finder loop)."""
    samples = as_tensor(samples, device)
    best = None
    for cid in cell_ids:
        cell = Cell(n_prb=n_prb, id=cid, nof_ports=1)
        off, metric, _ = refsignal_dl_sync_find(samples, cell, sf_idx)
        if metric >= threshold and (best is None or metric > best[2]):
            best = (cid, off, metric)
    return best
