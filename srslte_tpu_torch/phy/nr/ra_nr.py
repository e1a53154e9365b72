"""NR resource allocation: MCS tables, TBS determination, RIV (38.214 §5.1.3).

Reference behavior: lib/src/phy/phch/ra_nr.c (ra_nr_table1/2 MCS entries,
ra_nr_tbs_table, srsran_ra_nr_tbs:416) — spec constants from 38.214 tables
5.1.3.1-1/2 and 5.1.3.2-1.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..modem.modem import Modulation

# 38.214 table 5.1.3.1-1 (MCS index table 1): (Qm, R*1024)
MCS_TABLE_1 = [
    (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 438), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910),
    (6, 948),
]

# 38.214 table 5.1.3.1-2 (MCS index table 2, 256QAM): (Qm, R*1024)
MCS_TABLE_2 = [
    (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378), (4, 434),
    (4, 490), (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (8, 682.5),
    (8, 711), (8, 754), (8, 797), (8, 841), (8, 885), (8, 916.5), (8, 948),
]

# 38.214 table 5.1.3.2-1: TBS for N_info <= 3824
TBS_TABLE_NR = [
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144,
    152, 160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320,
    336, 352, 368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640,
    672, 704, 736, 768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160,
    1192, 1224, 1256, 1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736,
    1800, 1864, 1928, 2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600,
    2664, 2728, 2792, 2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
]

_QM_TO_MOD = {2: Modulation.QPSK, 4: Modulation.QAM16, 6: Modulation.QAM64,
              8: Modulation.QAM256}


def nr_mcs(mcs: int, table: str = "qam64") -> tuple[int, float]:
    """(Qm, code rate R) for an MCS index."""
    qm, r1024 = (MCS_TABLE_1 if table == "qam64" else MCS_TABLE_2)[mcs]
    return qm, r1024 / 1024.0


def nr_tbs(n_re: int, r: float, qm: int, layers: int = 1,
           scaling: float = 1.0) -> int:
    """TBS determination, 38.214 §5.1.3.2 steps 2-4 (ra_nr.c:416)."""
    import math

    n_info = int(n_re * scaling * r * qm * layers)
    if n_info <= 3824:
        n = max(3, int(math.floor(math.log2(max(n_info, 1)))) - 6)
        n_info_p = max(TBS_TABLE_NR[0], (1 << n) * (n_info >> n))
        for t in TBS_TABLE_NR:
            if n_info_p <= t:
                return t
        return TBS_TABLE_NR[-1]
    n = int(math.floor(math.log2(n_info - 24))) - 5
    n_info_p = max(3840, (1 << n) * int(round((n_info - 24) / (1 << n))))
    if r <= 0.25:
        c = -(-(n_info_p + 24) // 3816)
        return 8 * c * (-(-(n_info_p + 24) // (8 * c))) - 24
    if n_info_p > 8424:
        c = -(-(n_info_p + 24) // 8424)
        return 8 * c * (-(-(n_info_p + 24) // (8 * c))) - 24
    return 8 * (-(-(n_info_p + 24) // 8)) - 24


def riv_nr(n_bwp: int, rb_start: int, l_rb: int) -> int:
    """Type-1 frequency RA RIV (38.214 §5.1.2.2.2 — LTE-style formula)."""
    if l_rb < 1 or rb_start + l_rb > n_bwp:
        raise ValueError("invalid NR type-1 allocation")
    if (l_rb - 1) <= n_bwp // 2:
        return n_bwp * (l_rb - 1) + rb_start
    return n_bwp * (n_bwp - l_rb + 1) + (n_bwp - 1 - rb_start)


def riv_nr_decode(n_bwp: int, riv: int) -> tuple[int, int]:
    l_rb = riv // n_bwp + 1
    rb_start = riv % n_bwp
    if rb_start + l_rb > n_bwp:
        l_rb = n_bwp - l_rb + 2
        rb_start = n_bwp - 1 - rb_start
    return rb_start, l_rb


@dataclass(frozen=True)
class NrGrant:
    """NR shared-channel allocation (single layer)."""

    prb_start: int
    n_prb: int
    mcs: int
    mcs_table: str = "qam64"
    rv: int = 0
    ndi: int = 0
    harq_pid: int = 0
    start_sym: int = 1
    n_sym: int = 13  # mapping type A full slot (symbol 0 = PDCCH)
    n_layers: int = 1

    @property
    def qm(self) -> int:
        return nr_mcs(self.mcs, self.mcs_table)[0]

    @property
    def modulation(self) -> Modulation:
        return _QM_TO_MOD[self.qm]

    @property
    def rate(self) -> float:
        return nr_mcs(self.mcs, self.mcs_table)[1]

    def n_re(self, dmrs_in_alloc: int = 12) -> int:
        """N_RE per 38.214 §5.1.3.2 step 1 (capped at 156/PRB)."""
        n_re_prime = 12 * self.n_sym - dmrs_in_alloc
        return min(156, n_re_prime) * self.n_prb

    @property
    def tbs(self) -> int:
        return nr_tbs(self.n_re(), self.rate, self.qm, layers=self.n_layers)
