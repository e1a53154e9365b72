"""CQI reporting (36.213 §7.2, cqi.c equivalent).

Reference behavior: lib/src/phy/phch/cqi.c — periodic wideband report
packing (4-bit CQI [+ spatial bits]), aperiodic wideband + subband-UE
formats, and the SNR -> CQI mapping used by srsue (cqi_from_snr).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

# SNR thresholds (dB) for CQI 1..15 — the piecewise table the reference uses
# (cqi.c srsran_cqi_from_snr), ~90% throughput targets per 36.213 table 7.2.3-1
_CQI_SNR_DB = (-6.7, -4.7, -2.3, 0.2, 2.4, 4.3, 5.9, 8.1, 10.3, 11.7,
               14.1, 16.3, 18.7, 21.0, 22.7)


def cqi_from_snr(snr_db: float) -> int:
    """Highest CQI whose threshold is below the SNR (0 = out of range)."""
    cqi = 0
    for i, thr in enumerate(_CQI_SNR_DB):
        if snr_db >= thr:
            cqi = i + 1
    return cqi


# CQI index -> (modulation order Qm, code rate x1024), 36.213 table 7.2.3-1
CQI_TABLE = (
    None, (2, 78), (2, 120), (2, 193), (2, 308), (2, 449), (2, 602),
    (4, 378), (4, 490), (4, 616), (6, 466), (6, 567), (6, 666), (6, 772),
    (6, 873), (6, 948))


@dataclass(frozen=True)
class WidebandCqi:
    cqi: int  # 0..15
    ri: int | None = None  # rank indicator (TM3/TM4)
    pmi: int | None = None  # precoder index (TM4)

    def nof_bits(self) -> int:
        return 4 + (1 if self.ri is not None else 0) \
            + (2 if self.pmi is not None else 0)

    def pack(self) -> np.ndarray:
        bits = [(self.cqi >> i) & 1 for i in (3, 2, 1, 0)]
        if self.pmi is not None:
            bits += [(self.pmi >> 1) & 1, self.pmi & 1]
        if self.ri is not None:
            bits += [self.ri & 1]
        return np.asarray(bits, np.uint8)

    @staticmethod
    def unpack(bits: np.ndarray, has_pmi: bool = False,
               has_ri: bool = False) -> "WidebandCqi":
        pos = 0
        cqi = int(sum(int(bits[i]) << (3 - i) for i in range(4)))
        pos = 4
        pmi = ri = None
        if has_pmi:
            pmi = (int(bits[pos]) << 1) | int(bits[pos + 1])
            pos += 2
        if has_ri:
            ri = int(bits[pos])
        return WidebandCqi(cqi=cqi, ri=ri, pmi=pmi)


@dataclass(frozen=True)
class SubbandCqi:
    """Aperiodic UE-selected subband report (wideband + diff per subband)."""

    wideband: int
    subband_diff: tuple  # 2-bit offsets per subband

    def pack(self) -> np.ndarray:
        bits = [(self.wideband >> i) & 1 for i in (3, 2, 1, 0)]
        for d in self.subband_diff:
            bits += [(d >> 1) & 1, d & 1]
        return np.asarray(bits, np.uint8)

    @staticmethod
    def unpack(bits: np.ndarray, n_subbands: int) -> "SubbandCqi":
        wb = int(sum(int(bits[i]) << (3 - i) for i in range(4)))
        diffs = tuple((int(bits[4 + 2 * s]) << 1) | int(bits[5 + 2 * s])
                      for s in range(n_subbands))
        return SubbandCqi(wideband=wb, subband_diff=diffs)
