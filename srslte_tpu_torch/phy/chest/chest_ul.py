"""UL channel estimation from PUSCH DMRS (chest_ul.c equivalent).

Reference behavior: lib/src/phy/ch_estimation/chest_ul.c — LS estimate at the
two DMRS symbols, frequency-domain smoothing, linear interpolation across the
subframe, noise estimate from the smoothing residual.

The smoothing is a 5-tap moving average with edge padding and the time
interpolation a fixed weight per symbol: a few elementwise passes over
[..., 2, M] and [..., nsymb_sf, M].
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import Cell
from .refsignal_ul import dmrs_symbol, pusch_dmrs

SMOOTH_TAPS = 5


@dataclass(frozen=True)
class ChestUl:
    cell: Cell

    def estimate(self, grid, sf_idx: int, prb_start: int, m_prb: int,
                 n_dmrs2: int = 0, device=None):
        """grid [..., nsymb_sf, nof_re] -> (ce [..., nsymb_sf, M], info).

        ce covers the allocated subcarriers only (M = m_prb*12); info holds
        "noise" [...] (with the c/(c-1) bias correction of a c-tap average)
        and "h_dmrs" [..., 2, M], the smoothed pilot estimates.
        """
        grid = as_tensor(grid, device).to(torch.complex64)
        dev = grid.device
        o = self.cell.ofdm
        ls = dmrs_symbol(self.cell)
        sym = np.array([ls, o.nsymb_slot + ls])
        k0 = prb_start * 12
        m = m_prb * 12
        pil = table(("pusch_dmrs", self.cell, sf_idx, m_prb, n_dmrs2), dev,
                    lambda: pusch_dmrs(self.cell, sf_idx, m_prb, n_dmrs2=n_dmrs2))
        y = grid[..., torch.as_tensor(sym, device=dev), k0 : k0 + m]  # [..., 2, M]
        h_ls = y * torch.conj(pil)  # unit-amplitude pilots

        # frequency smoothing: moving average over edge-padded estimates
        pad = SMOOTH_TAPS // 2
        hp = torch.cat([h_ls[..., :1].expand(h_ls.shape[:-1] + (pad,)), h_ls,
                        h_ls[..., -1:].expand(h_ls.shape[:-1] + (pad,))], dim=-1)
        tap = float(np.float32(1.0) / np.float32(SMOOTH_TAPS))
        h_sm = hp[..., 0:m] * tap
        for i in range(1, SMOOTH_TAPS):
            h_sm = h_sm + hp[..., i : i + m] * tap

        noise = torch.mean(torch.abs(h_ls - h_sm) ** 2, dim=(-1, -2))
        noise = noise * (SMOOTH_TAPS / (SMOOTH_TAPS - 1))  # bias correction

        # linear time interpolation across the subframe between the 2 pilots
        t = table(("chest_ul_t", o), dev, lambda: (
            (np.arange(o.nsymb_sf) - sym[0]) / (sym[1] - sym[0])).astype(np.float32)[:, None])
        ce = h_sm[..., 0:1, :] * (1 - t) + h_sm[..., 1:2, :] * t
        return ce, {"noise": noise, "h_dmrs": h_sm}
