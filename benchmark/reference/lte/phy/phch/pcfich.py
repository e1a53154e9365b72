# Frozen copy of srslte_tpu_torch/phy/phch/pcfich.py at commit e4337f4, unchanged but for this line.
"""PCFICH: CFI indicator channel (36.211 §6.7, 36.212 §5.3.4).

Reference behavior: lib/src/phy/phch/pcfich.c: 32-bit CFI codewords,
scrambling with c_init = (ns/2+1)(2NID+1)*2^9 + NID, QPSK, 4 REG quadruplets
(regs.c geometry), decode by correlation against the 3 codewords (:151).

Decode correlates the 32 received LLRs against the whole codebook with one
[3, 32] product, batched over subframes; 1 port, 2-port SFBC or 4-port
SFBC-FSTD.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import Cell
from ..common.scrambling import pcfich_cinit
from ..common.sequence import gold_sequence
from ..mimo.mimo import diversity_combine, diversity_put
from ..modem.modem import Modulation, demod_soft, modulate
from .regs import reg_layout

# 36.212 table 5.3.4-1
_CFI_CW = np.array([
    [0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1],
    [1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0],
    [1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1, 0, 1, 1],
], np.uint8)


def cfi_codeword_bits(cell_id: int, sf_idx: int, cfi: int) -> np.ndarray:
    """The scrambled 32-bit CFI codeword of a subframe: uint8 [32]."""
    return _CFI_CW[cfi - 1] ^ gold_sequence(pcfich_cinit(sf_idx, cell_id), 32)


@functools.lru_cache(maxsize=None)
def _codebook_signed(cell_id: int, sf_idx: int) -> np.ndarray:
    """Scrambled +-1 codebook [3, 32] (for correlation decoding)."""
    c = gold_sequence(pcfich_cinit(sf_idx, cell_id), 32)
    return (1.0 - 2.0 * (_CFI_CW ^ c).astype(np.float32)).astype(np.float32)


@dataclass(frozen=True)
class Pcfich:
    cell: Cell
    sf_idx: int

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        return reg_layout(self.cell).pcfich_re

    def _re_idx_t(self, device) -> torch.Tensor:
        return table(("pcfich_re", self.cell), device,
                     lambda: self.re_idx.astype(np.int64))

    def encode(self, grids, cfi: int, device=None):
        """Place the CFI codeword (a new tensor). grids [..., nports, nsym, nre]."""
        grids = as_tensor(grids, device)
        sym = modulate(as_tensor(cfi_codeword_bits(self.cell.id, self.sf_idx, cfi), grids.device),
                       Modulation.QPSK)  # [16]
        o = self.cell.ofdm
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        diversity_put(flat, self._re_idx_t(grids.device), sym, self.cell.nof_ports)
        return flat.reshape(grids.shape)

    def decode(self, grid, ce, device=None):
        """grid [..., nsym, nre], ce [..., nports, nsym, nre] -> (cfi, corr).

        cfi in {1,2,3} (int32); corr = normalized correlation of the winner.
        """
        grid = as_tensor(grid, device)
        ce = as_tensor(ce, grid.device)
        o = self.cell.ofdm
        idx = self._re_idx_t(grid.device)
        y = grid.reshape(grid.shape[:-2] + (-1,))[..., idx]
        cef = ce.reshape(ce.shape[:-2] + (o.nsymb_sf * o.nof_re,))
        xhat = diversity_combine(y, cef, idx, self.cell.nof_ports)[0]
        llr = demod_soft(xhat, Modulation.QPSK)  # [..., 32], positive => bit 1
        cb = table(("pcfich_cb", self.cell.id, self.sf_idx), grid.device,
                   lambda: _codebook_signed(self.cell.id, self.sf_idx))
        corr = -torch.matmul(llr, cb.T)  # +1 maps bit 0
        best = torch.argmax(corr, dim=-1)
        norm = torch.sum(torch.abs(llr), dim=-1)
        conf = torch.gather(corr, -1, best[..., None])[..., 0] / torch.clamp(norm, min=1e-9)
        return (best + 1).to(torch.int32), conf
