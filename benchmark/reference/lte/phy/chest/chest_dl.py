# Frozen copy of srslte_tpu_torch/phy/chest/chest_dl.py at commit e4337f4, unchanged but for this line.
"""Downlink channel estimation from CRS (chest_dl.c equivalent).

Reference behavior: lib/src/phy/ch_estimation/chest_dl.c: LS estimates at
pilot REs (rx * conj(ref)), optional time-averaging across the subframe's CRS
symbols (average_pilots, chest_dl.c:558), linear interpolation in frequency
with edge extrapolation (:438), linear interpolation/extrapolation in time,
noise estimated from the pilot residual (:325).

The pilot extraction is a static gather, interpolation is a precomputed weight
matrix per (cell, port) bucket applied as one product
[..., n_pilots] @ [n_pilots, nof_re], and everything vectorizes over leading
batch dims (subframes, carriers, rx antennas).  Three algorithms, for 1, 2
and 4 ports: "average" (SRSRAN_ESTIMATOR_ALG_AVERAGE), "interpolate" and
"wiener" (a wiener_dl.c analog); their weight matrices are host tables built
once per cell bucket, never per call.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import Cell
from . import refsignal_dl as rs

ALGORITHMS = ("average", "interpolate", "wiener")


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


def _wiener_matrix(pilot_k: np.ndarray, n: int, tau_max: float,
                   snr_lin: float, out_k: np.ndarray | None = None) -> np.ndarray:
    """MMSE (Wiener) frequency filter [P, n] for a uniform PDP of length
    tau_max (fraction of the symbol; CP-length is the natural choice).

    R(dk) = E[h(k) h*(k+dk)] for a uniform power-delay profile on
    [0, tau_max*N] samples: sinc envelope with a linear phase, the same
    model wiener_dl.c tabulates.  W = R_dp (R_pp + I/snr)^-1.

    pilot_k/out_k must be FFT-BIN coordinates (continuous spacing); the
    caller accounts for the skipped DC bin in the RE grid.
    """
    # uniform PDP on [a, b] with margins: robust to taps slightly outside
    # the CP and to timing-offset bias (wiener_dl.c centers similarly)
    a, b = -0.25 * tau_max, 1.25 * tau_max

    def corr(dk):
        x = np.pi * dk * (b - a)
        s = np.where(np.abs(x) < 1e-9, 1.0, np.sin(x) / np.where(x == 0, 1, x))
        return s * np.exp(-1j * np.pi * dk * (a + b))

    kp = pilot_k.astype(np.float64)
    ka = (np.arange(n, dtype=np.float64) if out_k is None
          else np.asarray(out_k, np.float64))
    r_pp = corr(kp[:, None] - kp[None, :])
    r_dp = corr(ka[:, None] - kp[None, :])
    w = r_dp @ np.linalg.inv(r_pp + np.eye(len(kp)) / snr_lin)
    return w.T.astype(np.complex64)  # [P, n] for pil @ W


@dataclass(frozen=True)
class ChestDL:
    """Channel estimator for one cell bucket.

    algorithm: "average" (time-average CRS symbols then one freq interp, the
    C library's SRSRAN_ESTIMATOR_ALG_AVERAGE), "interpolate" (per-CRS-symbol
    freq interp + linear time interp), or "wiener" (MMSE frequency filter
    assuming a CP-length uniform PDP at wiener_snr_db, a wiener_dl.c analog).
    """

    cell: Cell
    algorithm: str = "average"
    wiener_snr_db: float = 20.0

    def __post_init__(self):
        if self.algorithm not in ALGORITHMS:
            raise ValueError(f"unknown ChestDL algorithm {self.algorithm!r}")

    @functools.cached_property
    def _tables(self):
        """Per-port static tables: (syms, ks, allk, w, tw, slot, cnt); the
        union grid allk, slot and cnt for "average" and "wiener", the time
        weights tw [S, nsym] for "interpolate"."""
        o = self.cell.ofdm
        tabs = []
        for port in range(self.cell.nof_ports):
            syms, ks = rs.crs_re_indices(self.cell, port)
            if self.algorithm in ("average", "wiener"):
                # merge all CRS symbols: pilot freq positions = union of shifts
                allk = np.unique(ks.reshape(-1))
                if self.algorithm == "wiener":
                    cp = o.cp_lens_slot()[1]
                    # RE-grid index -> continuous bin coordinate (the grid
                    # skips the DC bin between halves)
                    half = o.nof_re // 2
                    pk = allk + (allk >= half)
                    ok_ = np.arange(o.nof_re) + (np.arange(o.nof_re) >= half)
                    w = _wiener_matrix(pk, o.nof_re, cp / o.symbol_sz,
                                       10 ** (self.wiener_snr_db / 10), ok_)
                else:
                    w = _interp_matrix(allk, o.nof_re)  # [P, nof_re]
                slot = np.searchsorted(allk, ks)  # [S, 2nprb] -> union position
                cnt = np.zeros(len(allk), np.float32)
                for s in range(ks.shape[0]):
                    np.add.at(cnt, slot[s], 1.0)
                tabs.append((syms, ks, allk, w, None, slot, cnt))
            else:
                w = np.stack([_interp_matrix(k, o.nof_re) for k in ks])  # [S, P, nof_re]
                tw = _interp_matrix(syms.astype(np.float64), o.nsymb_sf)  # [S, nsym]
                tabs.append((syms, ks, None, w, tw, None, None))
        return tabs

    def pilots(self, sf_idx: int, port: int) -> np.ndarray:
        return rs.crs_pilots(self.cell, sf_idx, port)

    def estimate(self, grid, sf_idx: int, device=None):
        """grid [..., nsym_sf, nof_re] -> (ce [..., nports, nsym_sf, nof_re],
        info dict with noise/rsrp/snr per batch element).

        Single-rx-antenna semantics; a leading rx-antenna axis is one more
        batch dim.  With "average" and "wiener" every symbol of a port gets
        the same estimate.
        """
        grid = as_tensor(grid, device)
        dev = grid.device
        o = self.cell.ofdm
        ces, noises, rsrps = [], [], []
        for port in range(self.cell.nof_ports):
            _, _, allk, w, tw, slot, cnt = self._tables[port]
            key = ("chest", self.cell, self.algorithm, self.wiener_snr_db, port)
            refs = rs.crs_pilot_tensor(self.cell, sf_idx, port, dev)  # [S, 2nprb]
            rx = rs.get_crs(grid, self.cell, port)  # [., S, 2nprb]
            ls = rx * torch.conj(refs)  # LS estimates

            rsrp = torch.abs(torch.mean(ls, dim=(-1, -2))) ** 2  # per batch element
            w_t = table(key + ("w",), dev, lambda: w, dtype=ls.dtype)
            if self.algorithm in ("average", "wiener"):
                # average the S shifted pilot combs onto the union grid allk
                slot_t = table(key + ("slot",), dev, lambda: slot.astype(np.int64))
                acc = torch.zeros(ls.shape[:-2] + (len(allk),), dtype=ls.dtype,
                                  device=dev)
                for s in range(ls.shape[-2]):
                    acc.index_add_(-1, slot_t[s], ls[..., s, :])
                pil = acc / table(key + ("cnt",), dev, lambda: cnt)
                ce_f = torch.matmul(pil, w_t)  # [., nof_re]
                ce = ce_f[..., None, :].expand(ce_f.shape[:-1] + (o.nsymb_sf, o.nof_re))
                # noise from the pilot residual; averaging cnt pilots leaves
                # sigma^2*(1-1/cnt), so rescale (exact for uniform cnt)
                sm = pil[..., slot_t]  # [., S, 2nprb]
                c = float(cnt.mean())
                scale = c / (c - 1.0) if c > 1.0 else 0.0
                noise = torch.mean(torch.abs(ls - sm) ** 2, dim=(-1, -2)) * scale
            else:
                # per CRS symbol a frequency interpolation, then linear in time
                ce_sym = torch.einsum("...sp,spk->...sk", ls, w_t)  # [., S, nof_re]
                tw_t = table(key + ("tw",), dev, lambda: tw, dtype=ls.dtype)
                ce = torch.matmul(tw_t.T, ce_sym)  # [., nsym, nof_re]
                mid = torch.mean(ls, dim=-2, keepdim=True)
                noise = torch.mean(torch.abs(ls - mid) ** 2, dim=(-1, -2))
            ces.append(ce)
            noises.append(noise)
            rsrps.append(rsrp)
        ce = torch.stack(ces, dim=-3)  # [..., nports, nsym, nre]
        noise = torch.mean(torch.stack(noises, dim=-1), dim=-1)
        rsrp = torch.mean(torch.stack(rsrps, dim=-1), dim=-1)
        snr = rsrp / torch.clamp(noise, min=1e-12)
        return ce, {"noise": noise, "rsrp": rsrp, "snr": snr}
