# Frozen copy of srslte_tpu_torch/phy/phch/phich.py at commit e4337f4, unchanged but for this line.
"""PHICH: HARQ indicator channel (36.211 §6.9).

Reference behavior: lib/src/phy/phch/phich.c: BPSK HI spread by SF-4
orthogonal sequences (8 per group: 4 real Walsh x {1, j}), repeated 3x,
scrambled (c_init as PCFICH §6.9.1), mapped to 3 REGs per group, all in
symbol 0 (normal duration) or one per symbol 0/1/2 (extended duration,
geometry from regs.py); 1 port, 2-port SFBC or 4-port SFBC-FSTD.

All 8 sequences of all groups encode and decode as one product against the
[8, 12] spread matrix: despreading is a matmul, and the per-sequence loop of
phich.c disappears.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import Cell
from ..common.scrambling import pcfich_cinit  # §6.9.1 uses the same c_init form
from ..common.sequence import gold_sequence
from ..mimo.mimo import diversity_combine, diversity_put
from .regs import reg_layout

NSF = 4  # spreading factor, normal CP
NSEQ = 8  # orthogonal sequences per group


@functools.lru_cache(maxsize=1)
def _walsh() -> np.ndarray:
    """[8, 4] complex orthogonal codes (36.211 table 6.9.1-2, normal CP)."""
    w = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]],
                 np.complex64)
    return np.concatenate([w, 1j * w]).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _spread_matrix(cell_id: int, sf_idx: int) -> np.ndarray:
    """[8, 12]: sequence nseq -> chip values including scrambling.

    d(i) = w(i mod 4) * (1 - 2c(i)) for i = 0..11 (3 repetitions).
    """
    c = gold_sequence(pcfich_cinit(sf_idx, cell_id), 12).astype(np.float32)
    s = (1 - 2 * c)[None, :]
    w = np.tile(_walsh(), (1, 3))  # [8, 12]
    return (w * s).astype(np.complex64)


@dataclass(frozen=True)
class Phich:
    cell: Cell
    sf_idx: int

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        return reg_layout(self.cell).phich_re  # [ngroups, 12]

    @property
    def ngroups(self) -> int:
        return self.re_idx.shape[0]

    def _tables(self, device):
        idx = table(("phich_re", self.cell), device, lambda: self.re_idx.astype(np.int64))
        m = table(("phich_spread", self.cell.id, self.sf_idx), device,
                  lambda: _spread_matrix(self.cell.id, self.sf_idx))
        return idx, m

    def encode(self, grids, ack, device=None):
        """ack [..., ngroups, 8] in {-1: off, 0: NACK, 1: ACK} -> grids (a new
        tensor; the PHICH is added to what the grids hold).

        HI bit b: ACK=1 -> symbol +1, NACK=0 -> -1 (BPSK of b with the
        C library's convention), off -> 0 amplitude.
        """
        grids = as_tensor(grids, device)
        ack = as_tensor(ack, grids.device)
        idx, m = self._tables(grids.device)
        amp = (ack >= 0).to(torch.float32)
        sym = (2.0 * torch.clamp(ack, min=0) - 1.0) * amp  # +-1 or 0
        d = torch.matmul(sym.to(torch.complex64), m)  # [..., g, 12]
        d = d / np.sqrt(2)  # group power normalization
        o = self.cell.ofdm
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        diversity_put(flat, idx, d, self.cell.nof_ports, add=True)
        return flat.reshape(grids.shape)

    def decode(self, grid, ce, noise_var=1e-3, device=None):
        """grid [..., nsym, nre], ce [..., nports, nsym, nre] ->
        (ack [..., ngroups, 8] bool, metric float distance)."""
        grid = as_tensor(grid, device)
        ce = as_tensor(ce, grid.device)
        idx, m = self._tables(grid.device)
        o = self.cell.ofdm
        y = grid.reshape(grid.shape[:-2] + (-1,))[..., idx]  # [..., g, 12]
        cef = ce.reshape(ce.shape[:-2] + (o.nsymb_sf * o.nof_re,))
        xhat = diversity_combine(y, cef, idx, self.cell.nof_ports)[0]
        corr = torch.matmul(xhat, torch.conj(m).T) / NSF / 3
        metric = corr.real * np.sqrt(2)
        return metric > 0, metric
