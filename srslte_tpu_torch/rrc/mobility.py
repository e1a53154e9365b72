"""Radio-link monitoring, RLF detection, and reestablishment identity.

Reference behavior:
- srsue/src/phy/sync.cc:664-688 — the PHY raises in-sync/out-of-sync per
  subframe from the CRS SNR; RRC counts N310 consecutive out-of-sync to
  start T310, N311 consecutive in-sync stops it, T310 expiry declares
  radio-link failure (36.331 5.3.11).
- srsue/src/stack/rrc/rrc.cc (reestablishment) — on RLF the UE selects the
  best cell and sends RRCConnectionReestablishmentRequest carrying
  (C-RNTI, PCI, ShortMAC-I); the eNB validates ShortMAC-I against the
  stored context (srsenb rrc::cell_res_user).
- 36.331 7.3 VarShortMAC-Input — ShortMAC-I is the 16 LSB of the integrity
  MAC computed over the PER encoding of (cellIdentity, physCellId, c-RNTI)
  with COUNT/BEARER/DIRECTION all ones.

Host-side control logic; the SNR feeding the monitor comes from the batched
chest path (phy/chest info["snr"]).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..security import integrity_mac
from .per import BitStr, F, Int, seq

# 36.331 7.3: VarShortMAC-Input ::= SEQUENCE of the three reestablishment
# identity fields, UNALIGNED PER
VAR_SHORT_MAC_INPUT = seq(
    F("cell_id", BitStr(28)),
    F("pci", Int(0, 503)),
    F("c_rnti", BitStr(16)))


def short_mac_i(k_rrc_int: bytes, ia: int, cell_id: int, pci: int,
                c_rnti: int) -> int:
    """16-bit ShortMAC-I over VarShortMAC-Input (36.331 5.3.7.4)."""
    buf = VAR_SHORT_MAC_INPUT.to_bytes(
        {"cell_id": cell_id, "pci": pci, "c_rnti": c_rnti})
    mac = integrity_mac(ia, k_rrc_int, count=0xFFFFFFFF, bearer=0x1F,
                        direction=1, data=buf)
    return int.from_bytes(mac[-2:], "big")


@dataclass
class RlmConfig:
    """ue-TimersAndConstants subset (36.331 9.2.13 / SIB2)."""

    n310: int = 4          # consecutive out-of-sync to start T310
    n311: int = 2          # consecutive in-sync to stop T310
    t310_ms: int = 20      # T310 expiry -> RLF
    t304_ms: int = 100     # handover supervision (mobilityControlInfo)
    out_of_sync_db: float = -3.0  # SNR below -> out-of-sync indication
    in_sync_db: float = 0.0       # SNR above -> in-sync indication


@dataclass
class RadioLinkMonitor:
    """N310/T310/N311 state machine fed with per-subframe serving SNR."""

    cfg: RlmConfig = field(default_factory=RlmConfig)
    n_oos: int = 0
    n_is: int = 0
    t310: int = -1  # ms remaining; -1 = stopped
    rlf: bool = False

    def step(self, snr_db: float, dt_ms: int = 1) -> bool:
        """Advance one subframe; returns True the instant RLF is declared."""
        if self.rlf:
            return False
        if snr_db < self.cfg.out_of_sync_db:
            self.n_oos += 1
            self.n_is = 0
        elif snr_db > self.cfg.in_sync_db:
            self.n_is += 1
            self.n_oos = 0
        if self.t310 < 0:
            if self.n_oos >= self.cfg.n310:
                self.t310 = self.cfg.t310_ms  # start T310
                self.n_oos = 0
        else:
            if self.n_is >= self.cfg.n311:
                self.t310 = -1  # recovered
                self.n_is = 0
            else:
                self.t310 -= dt_ms
                if self.t310 <= 0:
                    self.rlf = True
                    self.t310 = -1
                    return True
        return False

    def reset(self):
        self.n_oos = self.n_is = 0
        self.t310 = -1
        self.rlf = False
