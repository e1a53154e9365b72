"""Downlink channel estimation from CRS (chest_dl.c equivalent).

Reference behavior: lib/src/phy/ch_estimation/chest_dl.c: LS estimates at
pilot REs (rx * conj(ref)), time-averaging across the subframe's CRS symbols
(average_pilots, chest_dl.c:558), linear interpolation in frequency with edge
extrapolation (:438), noise estimated from the pilot residual (:325).

The pilot extraction is a static gather, interpolation is a precomputed weight
matrix per (cell, port) bucket applied as one product
[..., n_pilots] @ [n_pilots, nof_re], and everything vectorizes over leading
batch dims (subframes, carriers, rx antennas).

Ported: algorithm "average" (SRSRAN_ESTIMATOR_ALG_AVERAGE) for 1 and 2 ports.
"interpolate", "wiener" and 4 ports are ROADMAP queue A item 8.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import Cell
from . import refsignal_dl as rs


def _interp_matrix(pos: np.ndarray, n: int) -> np.ndarray:
    """Linear interpolation/extrapolation weights: [len(pos), n] float32.

    Value at x in [0, n) from samples at positions pos (sorted, >=2 entries).
    Matches srsran_interp_linear_offset semantics (linear between pilots,
    linear extrapolation at both edges).
    """
    pos = np.asarray(pos, np.float64)
    w = np.zeros((len(pos), n), np.float32)
    x = np.arange(n, dtype=np.float64)
    seg = np.clip(np.searchsorted(pos, x, side="right") - 1, 0, len(pos) - 2)
    x0, x1 = pos[seg], pos[seg + 1]
    t = (x - x0) / (x1 - x0)
    w[seg, np.arange(n)] = (1 - t).astype(np.float32)
    w[seg + 1, np.arange(n)] += t.astype(np.float32)
    return w


@dataclass(frozen=True)
class ChestDL:
    """Channel estimator for one cell bucket (algorithm "average": time-average
    the CRS symbols, then one frequency interpolation)."""

    cell: Cell
    algorithm: str = "average"

    def __post_init__(self):
        if self.algorithm != "average":
            raise NotImplementedError(
                f"ChestDL algorithm {self.algorithm!r} is not ported yet "
                "(ROADMAP queue A item 8: rest of DL)")
        if self.cell.nof_ports > 2:
            raise NotImplementedError(
                "ChestDL for 4 ports is not ported yet "
                "(ROADMAP queue A item 8: rest of DL)")

    @functools.cached_property
    def _tables(self):
        """Per-port static tables: (syms, ks, allk, w, slot, cnt)."""
        o = self.cell.ofdm
        tabs = []
        for port in range(self.cell.nof_ports):
            syms, ks = rs.crs_re_indices(self.cell, port)
            # merge all CRS symbols: pilot freq positions = union of shifts
            allk = np.unique(ks.reshape(-1))
            w = _interp_matrix(allk, o.nof_re)  # [P, nof_re]
            slot = np.searchsorted(allk, ks)  # [S, 2nprb] -> union position
            cnt = np.zeros(len(allk), np.float32)
            for s in range(ks.shape[0]):
                np.add.at(cnt, slot[s], 1.0)
            tabs.append((syms, ks, allk, w, slot, cnt))
        return tabs

    def pilots(self, sf_idx: int, port: int) -> np.ndarray:
        return rs.crs_pilots(self.cell, sf_idx, port)

    def estimate(self, grid, sf_idx: int, device=None):
        """grid [..., nsym_sf, nof_re] -> (ce [..., nports, nsym_sf, nof_re],
        info dict with noise/rsrp/snr per batch element).

        Single-rx-antenna semantics; batch for multiple rx antennas.
        """
        grid = as_tensor(grid, device)
        dev = grid.device
        o = self.cell.ofdm
        ces, noises, rsrps = [], [], []
        for port in range(self.cell.nof_ports):
            _, _, allk, w, slot, cnt = self._tables[port]
            key = ("chest", self.cell, port)
            refs = rs.crs_pilot_tensor(self.cell, sf_idx, port, dev)  # [S, 2nprb]
            rx = rs.get_crs(grid, self.cell, port)  # [., S, 2nprb]
            ls = rx * torch.conj(refs)  # LS estimates

            rsrp = torch.abs(torch.mean(ls, dim=(-1, -2))) ** 2  # per batch element
            # average the S shifted pilot combs onto the union grid allk
            slot_t = table(key + ("slot",), dev, lambda: slot.astype(np.int64))
            acc = torch.zeros(ls.shape[:-2] + (len(allk),), dtype=ls.dtype,
                              device=dev)
            for s in range(ls.shape[-2]):
                acc.index_add_(-1, slot_t[s], ls[..., s, :])
            pil = acc / table(key + ("cnt",), dev, lambda: cnt)
            w_t = table(key + ("w",), dev, lambda: w, dtype=ls.dtype)
            ce_f = torch.matmul(pil, w_t)  # [., nof_re]
            ce = ce_f[..., None, :].expand(ce_f.shape[:-1] + (o.nsymb_sf, o.nof_re))
            # noise from the pilot residual; averaging cnt pilots leaves
            # sigma^2*(1-1/cnt), so rescale (exact for uniform cnt)
            sm = pil[..., slot_t]  # [., S, 2nprb]
            c = float(cnt.mean())
            scale = c / (c - 1.0) if c > 1.0 else 0.0
            noise = torch.mean(torch.abs(ls - sm) ** 2, dim=(-1, -2)) * scale
            ces.append(ce)
            noises.append(noise)
            rsrps.append(rsrp)
        ce = torch.stack(ces, dim=-3)  # [..., nports, nsym, nre]
        noise = torch.mean(torch.stack(noises, dim=-1), dim=-1)
        rsrp = torch.mean(torch.stack(rsrps, dim=-1), dim=-1)
        snr = rsrp / torch.clamp(noise, min=1e-12)
        return ce, {"noise": noise, "rsrp": rsrp, "snr": snr}
