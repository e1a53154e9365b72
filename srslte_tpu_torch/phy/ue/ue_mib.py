"""MIB acquisition from synchronized subframe-0 samples (ue_mib.c).

Reference behavior: lib/src/phy/ue/ue_mib.c: OFDM demod + chest + PBCH
decode loop over frames until the CRC passes (srsran_ue_mib_decode).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

from ..._device import as_tensor
from ...utils.jit import lazy_jit
from ..chest.chest_dl import ChestDL
from ..common.params import Cell
from ..ofdm import Ofdm
from ..phch.pbch import Mib, Pbch


@dataclass(frozen=True)
class UeMib:
    """MIB decoder bound to a (cell_id, n_prb) bucket.

    PBCH lives in the center 72 subcarriers, so decode works at any receive
    bandwidth; n_prb=6 matches the C library's decimated MIB path.
    """

    cell_id: int
    n_prb: int = 6

    @property
    def cell(self) -> Cell:
        # 2-port CRS estimation so both antenna hypotheses are testable
        return Cell(n_prb=self.n_prb, id=self.cell_id, nof_ports=2)

    # the modem, estimator and decoder are kept, so that their host tables
    # are built once per decoder
    @functools.cached_property
    def ofdm(self) -> Ofdm:
        return Ofdm(self.cell.ofdm, normalize=True)

    @functools.cached_property
    def chest(self) -> ChestDL:
        return ChestDL(self.cell)

    @functools.cached_property
    def pbch(self) -> Pbch:
        return Pbch(self.cell)

    @lazy_jit(static_argnums=(0,))
    def _front(self, sf0_samples, device=None):
        """The OFDM demodulation and the 2-port estimate of subframe 0."""
        grid = self.ofdm.rx_sf(as_tensor(sf0_samples, device))
        ce, _ = self.chest.estimate(grid, 0)
        return grid, ce

    def decode(self, sf0_samples, device=None):
        """sf0_samples [sf_len] at the cell rate -> (ok, Mib|None, sfn_offset,
        nof_ports)."""
        grid, ce = self._front(sf0_samples, device)
        ok, bits, phase, ports = self.pbch.decode(grid, ce)
        if not ok:
            return False, None, 0, 0
        return True, Mib.unpack(bits), phase, ports
