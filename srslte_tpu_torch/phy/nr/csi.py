"""NR CSI reporting: quantization, triggers, UCI packing (38.212/38.214).

Reference behavior: lib/src/phy/phch/csi.c — periodic report triggering
(slot + period - offset) mod period == 0, wideband CRI/RI/PMI/CQI
quantization from CSI-RS measurements (SINR from channel RSRP minus
interference EPRE when an interference measurement exists), 4-bit CQI +
ceil(log2(K_csi_rs))-bit CRI packing into the o_csi1 UCI field, and the
'none' pass-through quantity.  The reference's SNRI->CQI conversion is a
stub returning 15 (csi.c:30-33); here it is a real quantizer against the
38.214 table 5.2.2.1-2/3/4 spectral-efficiency thresholds so reported CQI
tracks the measured SINR.

Quantization is a closed-form numpy searchsorted over static
threshold tables; measurements arrive as scalars already reduced on device
by csi_rs.py.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np

CSI_WIDEBAND_CQI_BITS = 4


class CqiTable(enum.Enum):
    TABLE_1 = "table_1"  # 38.214 table 5.2.2.1-2 (up to 64QAM)
    TABLE_2 = "table_2"  # 38.214 table 5.2.2.1-3 (up to 256QAM)
    TABLE_3 = "table_3"  # 38.214 table 5.2.2.1-4 (low SE / URLLC)


# Spectral efficiency per CQI index 1..15 (38.214 tables 5.2.2.1-2/3/4).
_SE = {
    CqiTable.TABLE_1: (0.1523, 0.2344, 0.3770, 0.6016, 0.8770, 1.1758,
                       1.4766, 1.9141, 2.4063, 2.7305, 3.3223, 3.9023,
                       4.5234, 5.1152, 5.5547),
    CqiTable.TABLE_2: (0.1523, 0.3770, 0.8770, 1.4766, 1.9141, 2.4063,
                       2.7305, 3.3223, 3.9023, 4.5234, 5.1152, 5.5547,
                       6.2266, 6.9141, 7.4063),
    CqiTable.TABLE_3: (0.0586, 0.0977, 0.1523, 0.2344, 0.3770, 0.6016,
                       0.8770, 1.1758, 1.4766, 1.9141, 2.4063, 2.7305,
                       3.3223, 3.9023, 4.5234),
}


def snri_db_to_cqi(table: CqiTable, snri_db: float) -> int:
    """Largest CQI whose spectral efficiency fits the measured SINR.

    SE(snr) = log2(1 + snr) (Shannon); CQI 0 = out of range.  The
    reference stubs this to 15 (csi.c:30); this is the real quantizer.
    """
    se = math.log2(1.0 + 10.0 ** (snri_db / 10.0))
    return int(np.searchsorted(np.asarray(_SE[table]), se, side="right"))


@dataclass(frozen=True)
class CsiPeriodic:
    period: int
    offset: int
    resource: int = 0  # PUCCH resource id


@dataclass(frozen=True)
class CsiReportCfg:
    """High-level report configuration (srsran_csi_hl_report_cfg_t)."""

    quantity: str = "cri_ri_pmi_cqi"  # or "none"
    periodic: CsiPeriodic | None = None
    cqi_table: CqiTable = CqiTable.TABLE_1
    nof_ports: int = 1
    K_csi_rs: int = 1


@dataclass(frozen=True)
class CsiMeasurements:
    """Reduced CSI-RS measurements (csi_rs.py measure outputs)."""

    wideband_snr_db: float
    wideband_rsrp_dbm: float = 0.0
    wideband_epre_dbm: float = 0.0


@dataclass(frozen=True)
class CsiReport:
    cqi: int
    ri: int = 0
    pmi: int = 0
    cri: int = 0


def report_trigger(cfg: CsiReportCfg, slot_idx: int) -> bool:
    """Periodic trigger (csi.c:36-44); aperiodic/none never self-trigger."""
    p = cfg.periodic
    if p is None:
        return False
    return (slot_idx + p.period - p.offset) % p.period == 0


def quantify(cfg: CsiReportCfg, channel: CsiMeasurements,
             interf: CsiMeasurements | None = None) -> CsiReport:
    """Wideband CRI/RI/PMI/CQI quantization (csi.c:46-77)."""
    sinr_db = channel.wideband_snr_db
    if interf is not None:
        sinr_db = channel.wideband_rsrp_dbm - interf.wideband_epre_dbm
    return CsiReport(cqi=snri_db_to_cqi(cfg.cqi_table, sinr_db))


def _cri_bits(cfg: CsiReportCfg) -> int:
    return math.ceil(math.log2(cfg.K_csi_rs)) if cfg.K_csi_rs > 1 else 0


def nof_bits(cfg: CsiReportCfg) -> int:
    """UCI bit count of one report (csi.c:78-93, csi_none_nof_bits)."""
    if cfg.quantity == "none":
        return cfg.K_csi_rs
    if cfg.nof_ports != 1:
        raise ValueError(f"unsupported nof_ports={cfg.nof_ports}")
    return CSI_WIDEBAND_CQI_BITS + _cri_bits(cfg)


def pack(cfg: CsiReportCfg, report: CsiReport) -> np.ndarray:
    """Report -> o_csi1 bits, MSB-first CQI then CRI (csi.c:95-112)."""
    if cfg.quantity == "none":
        raise ValueError("'none' quantity carries raw bits, nothing to pack")
    out = []
    for val, width in ((report.cqi, CSI_WIDEBAND_CQI_BITS),
                       (report.cri, _cri_bits(cfg))):
        out.extend((val >> (width - 1 - i)) & 1 for i in range(width))
    return np.asarray(out, np.uint8)


def unpack(cfg: CsiReportCfg, bits: np.ndarray) -> CsiReport:
    """o_csi1 bits -> report (csi.c:114-131)."""
    pos = 0
    vals = []
    for width in (CSI_WIDEBAND_CQI_BITS, _cri_bits(cfg)):
        v = 0
        for i in range(width):
            v = (v << 1) | int(bits[pos + i])
        vals.append(v)
        pos += width
    return CsiReport(cqi=vals[0], cri=vals[1])
