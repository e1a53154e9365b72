"""UE uplink transmitter composition (ue_ul.c equivalent).

Reference behavior: lib/src/phy/ue/ue_ul.c — srsran_ue_ul_encode: PUSCH/
PUCCH/SRS encode -> SC-FDMA modulation with the +0.5 subcarrier shift
(ue_ul.c:62 normalized OFDM, freq shift) -> CFO pre-compensation.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..common.params import Cell
from ..ofdm import Ofdm
from ..phch.pusch import Pusch
from ..sync.cfo import cfo_correct


@dataclass(frozen=True)
class UeUl:
    cell: Cell

    @property
    def ofdm(self) -> Ofdm:
        return Ofdm(self.cell.ofdm, normalize=True, freq_shift=0.5)

    def encode_pusch(self, pusch: Pusch, bits, cfo: float = 0.0, device=None, **uci):
        """bits [..., tbs] -> time samples [..., sf_len].

        **uci forwards ack=/ri=/cqi= payloads when pusch carries a UciCfgUl.
        """
        grid = pusch.encode(bits, device=device, **uci)
        samples = self.ofdm.tx_sf(grid)
        if cfo:
            samples = cfo_correct(samples, -cfo, self.cell.ofdm.symbol_sz)
        return samples

    def encode_pucch(self, pucch, ack_bits=(), cqi_bits=(), device=None):
        """PUCCH-only subframe (SR / ACK / CQI) -> time samples [..., sf_len];
        the payloads as `Pucch.encode` takes them."""
        grid = pucch.encode(ack_bits=ack_bits, cqi_bits=cqi_bits, device=device)
        return self.ofdm.tx_sf(grid)
