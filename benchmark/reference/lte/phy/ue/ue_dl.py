# Frozen copy of srslte_tpu_torch/phy/ue/ue_dl.py at commit e4337f4, unchanged but for this line.
"""UE downlink receiver composition (ue_dl.c equivalent).

Reference behavior: lib/src/phy/ue/ue_dl.c: srsran_ue_dl_decode_fft_estimate
(:349): OFDM demod + channel estimation; then PDCCH search / PDSCH decode.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..._device import as_tensor
from ...utils.jit import lazy_jit
from ..chest.chest_dl import ChestDL
from ..common.params import Cell
from ..ofdm import Ofdm
from ..phch.pdsch import Pdsch


@dataclass(frozen=True)
class UeDl:
    # the modem and the estimator are kept: PyTorch runs eagerly, so building
    # them anew would rebuild their static tables on the host at every call
    cell: Cell
    chest_algorithm: str = "average"

    @functools.cached_property
    def ofdm(self) -> Ofdm:
        return Ofdm(self.cell.ofdm, normalize=True)

    @functools.cached_property
    def chest(self) -> ChestDL:
        return ChestDL(self.cell, algorithm=self.chest_algorithm)

    @lazy_jit(static_argnums=(0, 2))
    def fft_estimate(self, samples, sf_idx: int, device=None):
        """samples [..., sf_len] -> (grid, ce, info).

        Leading dims are batch dims: subframes, and rx antennas, whose
        estimates come out as ce [..., nrx, nports, nsym, nre] for the
        spatial-multiplexing decoders (`PdschSm.decode2`)."""
        grid = self.ofdm.rx_sf(as_tensor(samples, device))
        ce, info = self.chest.estimate(grid, sf_idx)
        return grid, ce, info

    def decode_pdsch(self, samples, pdsch: Pdsch, n_iter: int = 5, device=None):
        grid, ce, info = self.fft_estimate(samples, pdsch.sf_idx, device)
        bits, ok = pdsch.decode(grid, ce, info["noise"], n_iter=n_iter)
        return bits, ok, info
