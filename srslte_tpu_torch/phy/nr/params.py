"""NR carrier numerology (38.211 §4, phy_common_nr.h equivalent).

Minimal slot-level model: mu (SCS = 15*2^mu kHz), n_prb, 14-symbol slots,
normal CP.  The OFDM modem reuses phy/ofdm with the scaled numerology.
"""

from __future__ import annotations

from dataclasses import dataclass

NRE = 12
NSYMB_SLOT = 14


@dataclass(frozen=True)
class NrCarrier:
    n_prb: int = 52  # e.g. 10 MHz at 15 kHz SCS
    mu: int = 0
    n_id: int = 1  # N_ID^cell (0..1007)

    def __post_init__(self):
        if not (0 <= self.n_id < 1008):
            raise ValueError("invalid NR cell id")

    @property
    def scs_hz(self) -> int:
        return 15000 << self.mu

    @property
    def nof_re(self) -> int:
        return self.n_prb * NRE

    @property
    def slots_per_subframe(self) -> int:
        return 1 << self.mu
