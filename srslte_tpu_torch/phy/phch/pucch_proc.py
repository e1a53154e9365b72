"""PUCCH procedures: format selection, resource derivation, channel selection.

Reference behavior: lib/src/phy/phch/pucch_proc.c —
srsran_pucch_proc_select_format (:36-90), srsran_pucch_proc_get_resources
(:287-343: SR override, SPS TPC indexing, TDD resource lists, channel
selection, format 2/3), the FDD channel-selection resource + b(0)b(1)
mapping of 36.213 tables 10.1.2.2.1-3/4/5 (get_npucch_cs :345-437 TX,
pucch_cs_get_ack :200-235 RX), and the TDD n_pucch derivation + bundling
tables 10.1-2/3/4 (n_pucch_i_tdd :257-270, get_npucch_tdd :469-587).

Host code: the C library's if-chains become data tables matched once per
TTI on the host; nothing here touches the device.  The outputs (format,
n_pucch, b bits) parameterize `pucch.Pucch`.  The TDD branch of `get_npucch`
is copied as it stands, its M = 1 case included, which the JAX package
holds as an open spec fault (ROADMAP queue C item 3): the two packages
agree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# HARQ feedback states
NACK, ACK, DTX = 0, 1, 2


@dataclass(frozen=True)
class AckCfg:
    """Per-carrier HARQ-ACK context (srsran_uci_cfg_t.ack[i])."""

    nof_acks: int = 0
    ncce: tuple = (0,)
    grant_cc_idx: int = 0  # 0: grant came on the primary cell's PDCCH
    tpc_for_pucch: int = 0
    tdd_ack_m: int = 1  # M: bundling window size (TDD)


@dataclass(frozen=True)
class UciUsage:
    """What this TTI's UCI carries (subset of srsran_uci_cfg_t)."""

    acks: tuple = ()  # tuple[AckCfg, ...]
    cqi_enabled: bool = False
    ri_len: int = 0
    is_sr_tti: bool = False
    sr_positive: bool | None = None  # None: use is_sr_tti (eNB view)

    @property
    def total_ack(self) -> int:
        return sum(a.nof_acks for a in self.acks)

    @property
    def tx_sr(self) -> bool:
        if self.sr_positive is not None:
            return self.sr_positive
        return self.is_sr_tti


@dataclass(frozen=True)
class PucchProcCfg:
    """Dedicated PUCCH configuration (srsran_pucch_cfg_t resource fields)."""

    n_pucch_sr: int = 0
    n_pucch_1: int = 0  # N_pucch_1 dynamic-ACK region offset
    n_pucch_2: int = 0
    feedback_mode: str = "normal"  # normal | cs | pucch3
    n1_pucch_an_cs: tuple = ((0, 0), (0, 0), (0, 0), (0, 0))  # [tpc][j]
    n3_pucch_an_list: tuple = (0, 0, 0, 0)
    sps_enabled: bool = False
    n_pucch_1_sps: tuple = (0, 0, 0, 0)


def select_format(cell, cfg: PucchProcCfg, uci: UciUsage) -> str:
    """Format per pucch_proc.c:36-90 (pucch.py PucchConfig fmt strings)."""
    total = uci.total_ack
    ext_cp = getattr(cell.cp, "value", cell.cp) == "ext"
    if not uci.cqi_enabled and uci.ri_len == 0:
        if (cfg.feedback_mode == "pucch3" and uci.acks
                and total > uci.acks[0].nof_acks):
            return "3"
        if total == 1:
            return "1a"
        if 2 <= total <= 4:
            return "1b"  # with channel selection when > 2 (or cs mode)
        if uci.tx_sr:
            return "1"
        raise ValueError(f"unsupported ACK count {total} without CQI")
    if total == 0:
        return "2"
    if total == 1:
        return "2b" if ext_cp else "2a"
    if total == 2:
        return "2b"
    raise ValueError(f"unsupported ACK count {total} with CQI")


# ---------------------------------------------------------------------------
# resource derivation
# ---------------------------------------------------------------------------

def _np_tdd(p: int, n_prb: int) -> int:
    return 0 if p == 0 else n_prb * (12 * p - 4) // 36


def n_pucch_tdd(ncce: int, n_pucch_1: int, n_prb: int, m_total: int,
                m: int) -> int:
    """TDD resource for bundling-window slot m (pucch_proc.c:257-270)."""
    for p in range(4):
        np_, np1 = _np_tdd(p, n_prb), _np_tdd(p + 1, n_prb)
        if np_ <= ncce < np1:
            return (m_total - m - 1) * np_ + m * np1 + ncce + n_pucch_1
    raise ValueError(f"no Np bracket for ncce={ncce}")


def get_resources(cell, cfg: PucchProcCfg, uci: UciUsage,
                  fmt: str) -> list[int]:
    """Candidate n_pucch resources (pucch_proc.c:287-343)."""
    if uci.tx_sr and fmt != "3":
        return [cfg.n_pucch_sr]
    if fmt in ("1", "1a", "1b"):
        a0 = uci.acks[0] if uci.acks else AckCfg()
        if cfg.sps_enabled:
            return [cfg.n_pucch_1_sps[a0.tpc_for_pucch % 4]]
        if cell.frame_type == "tdd":
            return [n_pucch_tdd(a0.ncce[m], cfg.n_pucch_1, cell.n_prb,
                                a0.tdd_ack_m, m) for m in range(a0.tdd_ack_m)]
        if cfg.feedback_mode == "cs":
            out = []
            for i, a in enumerate(uci.acks):
                if len(out) >= 4:
                    break
                for j in range(a.nof_acks):
                    if a.grant_cc_idx == 0:
                        out.append(a.ncce[0] + cfg.n_pucch_1 + j)
                    elif i == 0:  # SPS PDSCH on PCell: higher-layer list
                        out.append(
                            cfg.n1_pucch_an_cs[a.tpc_for_pucch % 4][0] + j)
                    else:  # SCell grant: TPC indexes the configured list
                        out.append(
                            cfg.n1_pucch_an_cs[a.tpc_for_pucch % 4][j % 2])
            return out[:4]
        return [uci.acks[0].ncce[0] + cfg.n_pucch_1] if uci.acks else []
    if fmt == "3":
        a0 = uci.acks[0] if uci.acks else AckCfg()
        return [cfg.n3_pucch_an_list[a0.tpc_for_pucch % 4]]
    return [cfg.n_pucch_2]


# ---------------------------------------------------------------------------
# FDD channel selection (36.213 tables 10.1.2.2.1-3/4/5)
# ---------------------------------------------------------------------------

def _cs_tx(acks: tuple) -> tuple[int, tuple]:
    """ACK vector -> (resource index j, b(0)b(1)) — get_npucch_cs TX side.

    Conditions treat anything != ACK as NACK/DTX, like the reference.
    """
    a = [1 if x == ACK else 0 for x in acks]
    n = len(a)
    if n == 1:
        return 0, (a[0],)  # format 1a
    if n == 2:
        j = 1 if a[1] else 0
        return j, ((1, 1) if a[0] else (0, 0))
    if n == 3:
        if not a[0] and not a[1]:
            j = 2
        elif a[2]:
            j = 1
        else:
            j = 0
        if not a[0] and not a[1] and not a[2]:
            b = (0, 0)
        elif not a[0] and a[1]:
            b = (0, 1)
        elif a[0] and not a[1]:
            b = (1, 0)
        else:
            b = (1, 1)
        return j, b
    if n == 4:
        if not a[2] and not a[3]:
            j, b = 0, (a[0], a[1])
        elif a[1] and a[2]:
            j, b = 1, (a[0], a[3])
        elif a[0]:
            j, b = 2, (a[3] & (0 if a[2] else 1), a[3] & (a[1] ^ a[2]))
        else:
            j, b = 3, (a[2], 1 if (a[3] and a[1] != a[2]) else 0)
        return j, b
    raise ValueError(f"channel selection supports 1..4 ACK, got {n}")


# RX tables: (j, b0, b1) -> ACK-bit positions set (pucch_cs_get_ack)
_CS_RX = {
    2: {(1, 1, 1): (0, 1), (0, 1, 1): (0,), (1, 0, 0): (1,)},
    3: {(1, 1, 1): (0, 1, 2), (1, 1, 0): (0, 2), (1, 0, 1): (1, 2),
        (2, 1, 1): (2,), (0, 1, 1): (0, 1), (0, 1, 0): (0,),
        (0, 0, 1): (1,), (1, 0, 0): ()},
    4: {(1, 1, 1): (0, 1, 2, 3), (2, 0, 1): (0, 2, 3), (1, 0, 1): (1, 2, 3),
        (3, 1, 1): (2, 3), (1, 1, 0): (0, 1, 2), (2, 0, 0): (0, 2),
        (1, 0, 0): (1, 2), (3, 1, 0): (2,), (2, 1, 1): (0, 1, 3),
        (2, 1, 0): (0, 3), (3, 0, 1): (1, 3), (3, 0, 0): (3,),
        (0, 1, 1): (0, 1), (0, 1, 0): (0,), (0, 0, 1): (1,), (0, 0, 0): ()},
}


def cs_get_ack(nof_ack: int, j: int, b: tuple) -> list[int] | None:
    """(detected resource j, decoded b bits) -> ACK vector, or None when
    the combination is not in the table (treated as DTX)."""
    tab = _CS_RX.get(nof_ack)
    if tab is None:
        raise ValueError(f"unsupported ACK count {nof_ack}")
    hit = tab.get((j, int(b[0]), int(b[1])))
    if hit is None:
        return None
    out = [0] * nof_ack
    for p in hit:
        out[p] = 1
    return out


# ---------------------------------------------------------------------------
# TDD bundling-window selection (36.213 tables 10.1-2/3/4)
# ---------------------------------------------------------------------------
# rows: (state pattern, resource index j, b0b1); pattern symbols:
#   A = ACK, N = NACK, D = DTX, n = NACK-or-DTX
_TDD_TAB = {
    2: ((("A", "A"), 1, (1, 1)), (("A", "n"), 0, (0, 1)),
        (("n", "A"), 1, (0, 0)), (("n", "N"), 1, (1, 0)),
        (("N", "D"), 0, (1, 0))),
    3: ((("A", "A", "A"), 2, (1, 1)), (("A", "A", "n"), 1, (1, 1)),
        (("A", "n", "A"), 0, (1, 1)), (("A", "n", "n"), 0, (0, 1)),
        (("n", "A", "A"), 2, (1, 0)), (("n", "A", "n"), 1, (0, 0)),
        (("n", "n", "A"), 2, (0, 0)), (("D", "D", "N"), 2, (0, 1)),
        (("D", "N", "n"), 1, (1, 0)), (("N", "n", "n"), 0, (1, 0))),
    4: ((("A", "A", "A", "A"), 1, (1, 1)), (("A", "A", "A", "n"), 1, (1, 0)),
        (("n", "n", "N", "D"), 2, (1, 1)), (("A", "A", "n", "A"), 1, (1, 0)),
        (("N", "D", "D", "D"), 0, (1, 0)), (("A", "A", "n", "n"), 1, (1, 0)),
        (("A", "n", "A", "A"), 3, (0, 1)), (("n", "n", "n", "N"), 3, (1, 1)),
        (("A", "n", "A", "N"), 1, (1, 0)), (("A", "n", "n", "A"), 0, (0, 1)),
        (("A", "n", "n", "n"), 0, (1, 1)), (("n", "A", "A", "A"), 3, (0, 1)),
        (("n", "N", "D", "D"), 1, (0, 0)), (("n", "A", "A", "n"), 2, (1, 0)),
        (("n", "A", "n", "A"), 3, (1, 0)), (("n", "A", "n", "n"), 1, (0, 1)),
        (("n", "n", "A", "A"), 3, (0, 1)), (("n", "n", "A", "n"), 2, (0, 0)),
        (("n", "n", "n", "A"), 3, (0, 0))),
}


def _match(sym: str, h: int) -> bool:
    return {"A": h == ACK, "N": h == NACK, "D": h == DTX,
            "n": h != ACK}[sym]


def tdd_select(harq: tuple) -> tuple[int, tuple] | None:
    """TDD bundling: HARQ states (ACK/NACK/DTX per window slot) ->
    (resource index, b0b1) per get_npucch_tdd; None when nothing is sent
    (all DTX)."""
    m = len(harq)
    if m == 1:
        return (0, (harq[0],)) if harq[0] != DTX else None
    for pat, j, b in _TDD_TAB[m]:
        if all(_match(s, h) for s, h in zip(pat, harq)):
            return j, b
    return None


def get_npucch(cell, cfg: PucchProcCfg, uci: UciUsage,
               harq: tuple) -> tuple[int, tuple]:
    """Final (n_pucch, b bits) — srsran_pucch_proc_get_npucch.

    harq: per-ACK-bit states (ACK/NACK/DTX).  SR-positive TTIs override
    to the SR resource with the original (bundled) bits.
    """
    fmt = select_format(cell, cfg, uci)
    res = get_resources(cell, cfg, uci, fmt)
    if uci.tx_sr and fmt != "3":
        return res[0], tuple(1 if h == ACK else 0 for h in harq)
    if cell.frame_type == "tdd" and fmt in ("1a", "1b"):
        sel = tdd_select(harq)
        if sel is None:
            return res[0], ()
        j, b = sel
        return res[min(j, len(res) - 1)], b
    if cfg.feedback_mode == "cs" and uci.total_ack >= 2:
        j, b = _cs_tx(harq)
        return res[min(j, len(res) - 1)], b
    return res[0], tuple(1 if h == ACK else 0 for h in harq)
