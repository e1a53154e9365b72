"""NR PUSCH processor, CP-OFDM single layer (38.211 §6.3.1, pusch_nr.c).

Reference behavior: lib/src/phy/phch/pusch_nr.c — the UL-SCH coding chain
(38.212 §6.2) is structurally identical to DL-SCH (same LDPC segmentation,
rate matching and concatenation; sch_nr.c is shared between both), the
scrambling c_init formula matches PDSCH (38.211 §6.3.1.1), and the type-1
DMRS layout is the DL formula on the PUSCH allocation.  The reference does
not implement transform precoding (DFT-s-OFDM) for NR and neither does this
package.

Grant-based operation mirrors NrPdsch; the UE encodes, the gNB decodes.
"""

from __future__ import annotations

from dataclasses import dataclass

from .pdsch_nr import NrPdsch


@dataclass(frozen=True)
class NrPusch(NrPdsch):
    """UL shared channel: NrPdsch's chain driven from the UE side
    (pusch_nr.c srsran_pusch_nr_encode/decode)."""
