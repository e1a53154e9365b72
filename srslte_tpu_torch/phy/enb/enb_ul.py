"""eNB uplink receiver composition (enb_ul.c equivalent).

Reference behavior: lib/src/phy/enb/enb_ul.c — SC-FDMA demodulation with the
-0.5 subcarrier shift, chest_ul + PUSCH decode (srsran_enb_ul_get_pusch),
PUCCH decode (srsran_enb_ul_get_pucch).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..common.params import Cell
from ..ofdm import Ofdm
from ..phch.pusch import Pusch


@dataclass(frozen=True)
class EnbUl:
    cell: Cell

    @property
    def ofdm(self) -> Ofdm:
        return Ofdm(self.cell.ofdm, normalize=True, freq_shift=-0.5)

    def decode_pusch(self, samples, pusch: Pusch, n_iter: int = 5, device=None,
                     siso_dtype: torch.dtype = torch.float32):
        """samples [..., sf_len] -> (bits, crc_ok, info); siso_dtype is the
        turbo decoder's working dtype (float32 or bfloat16)."""
        grid = self.ofdm.rx_sf(samples, device)
        return pusch.decode(grid, n_iter=n_iter, siso_dtype=siso_dtype)

    def decode_pucch(self, samples, pucch, device=None, **kw):
        """samples [..., sf_len] -> pucch.decode dict (SR/ACK/CQI)."""
        grid = self.ofdm.rx_sf(samples, device)
        return pucch.decode(grid, **kw)
