"""Neighbor-cell RSRP/RSRQ measurement (intra_measure.cc equivalent).

Reference behavior: srsue/src/phy/scell/intra_measure.cc: ringbuffer
captures measured asynchronously: per neighbor PCI, CRS-based RSRP, wideband
RSSI, RSRQ = N * RSRP / RSSI (36.214 definitions); PSS correlation confirms
presence.

All candidate PCIs measure from one captured grid batch in a single pass:
the per-PCI CRS index and pilot tables are stacked into [n_pci, S, 2 n_prb]
tables (uploaded once per bucket) and read with one gather.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ...utils.jit import lazy_jit
from ..chest.refsignal_dl import crs_pilots, crs_re_indices
from ..common.params import Cell, OfdmParams
from ..ofdm import Ofdm


@dataclass(frozen=True)
class IntraMeasure:
    """Measurer for one (n_prb, candidate PCI tuple) bucket."""

    n_prb: int
    pcis: tuple

    def _tables(self, sf_idx: int, device):
        """(syms [S, 1], ks [n_pci, S, K], pilots [n_pci, S, K]) on the device."""
        cells = [Cell(n_prb=self.n_prb, id=pci, nof_ports=1) for pci in self.pcis]
        syms = table(("im_syms", self), device,
                     lambda: crs_re_indices(cells[0], 0)[0].astype(np.int64)[:, None])
        ks = table(("im_ks", self), device,
                   lambda: np.stack([crs_re_indices(c, 0)[1] for c in cells]).astype(np.int64))
        refs = table(("im_pilots", self, sf_idx), device,
                     lambda: np.stack([crs_pilots(c, sf_idx, 0) for c in cells]))
        return syms, ks, refs

    @lazy_jit(static_argnums=(0, 2))
    def measure(self, samples, sf_idx: int, device=None):
        """samples [..., sf_len] aligned captures -> per-PCI metrics.

        Returns dict of tensors keyed rsrp/rsrq/rssi with leading axis =
        candidate PCI index (order of self.pcis), then batch dims.
        """
        x = as_tensor(samples, device)
        grid = Ofdm(OfdmParams(self.n_prb), normalize=True).rx_sf(x)  # [..., nsym, nre]
        rssi = torch.mean(torch.abs(grid) ** 2, dim=(-1, -2))
        sfs = sf_idx if isinstance(sf_idx, int) else 0
        syms, ks, refs = self._tables(sfs, grid.device)
        rx = grid[..., syms, ks]  # [..., n_pci, S, K]
        # coherent average per CRS symbol -> power (rejects noise and other
        # cells' CRS, which are pseudo-random with respect to this PCI)
        rsrp = (torch.abs(torch.mean(rx * torch.conj(refs), dim=-1)) ** 2).mean(dim=-1)
        rsrp = torch.movedim(rsrp, -1, 0)  # [n_pci, ...]
        rsrq = self.n_prb * rsrp / torch.clamp(rssi, min=1e-12)
        return {"rsrp": rsrp, "rsrq": rsrq, "rssi": rssi}
