"""eNB MAC downlink scheduler (srsenb/src/stack/mac/sched*.cc equivalent).

Reference behavior: sched_grid.cc (RBG bitmap grid + PDCCH CCE allocation
with collision checking, sf_grid_t::alloc_dl:154), schedulers/sched_time_rr
and sched_time_pf (round-robin / proportional-fair metrics), sched_ue.cc
(CQI -> MCS, buffer state from RLC, HARQ rv/ndi management).

Host Python: scheduling is control-plane work (runs once per TTI over tens
of UEs); the output is a list of grants the PHY encodes batched on device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..phy.common.params import Cell
from ..phy.phch.dci import Dci1, Dci1A, format1_size, pack_format1
from ..phy.phch.pdcch import Location, common_locations, ue_locations
from ..phy.phch.pdsch import dlsch_config, nof_re_pdsch, sf_flags
from ..phy.phch.ra import DlGrant, rbg_size, tbs_from_itbs
from ..phy.phch.regs import reg_layout
from .harq import RV_SEQ

# CQI (1-15) -> highest DL MCS with spectral efficiency below the CQI's
# (36.213 tables 7.2.3-1 / 7.1.7.1-1 mapping, as sched_ue.cc cqi_to_mcs)
CQI_TO_MCS = [0, 0, 2, 4, 6, 8, 11, 13, 15, 18, 20, 22, 24, 26, 28, 28]


@dataclass
class SchedUe:
    rnti: int
    cqi: int = 15
    buffer_bytes: int = 0
    avg_rate: float = 1.0  # PF average throughput (bits/tti)
    ndi: int = 0
    pid: int = 0


@dataclass
class DlAlloc:
    rnti: int
    grant: DlGrant
    dci: Dci1
    loc: Location
    tbs: int


@dataclass
class BcAlloc:
    """Common-search-space allocation (SIB/RAR/paging) — DCI 1A type-2.

    Reference: sched_carrier.cc bc_sched/ra_sched allocate broadcast before
    UE data, in the common space, with the P/SI/RA-RNTI 1A TBS semantics
    (I_TBS direct + N_prb_1A in {2,3} from the TPC LSB, ra_dl.c:374-385).
    """

    rnti: int
    grant: DlGrant
    dci: Dci1A
    loc: Location
    tbs: int


@dataclass
class SchedDl:
    """Per-TTI DL scheduler over one carrier."""

    cell: Cell
    policy: str = "rr"  # "rr" | "pf"
    cfi: int = 1
    ues: dict = field(default_factory=dict)
    _rr_next: int = 0

    def add_ue(self, rnti: int, **kw):
        self.ues[rnti] = SchedUe(rnti=rnti, **kw)

    def buffer_state(self, rnti: int, nof_bytes: int):
        self.ues[rnti].buffer_bytes = nof_bytes

    # -- core allocation ------------------------------------------------------
    def schedule_sf(self, tti: int, bc_requests=()):
        """One TTI: broadcast first, then UE data sharing the same RBG/CCE
        occupancy (sf_grid_t semantics, sched_grid.cc:154).

        bc_requests: [(rnti, nof_bytes, rv)] for SI/RA/P-RNTI payloads.
        Returns (bc_allocs, dl_allocs).
        """
        p = rbg_size(self.cell.n_prb)
        n_rbg = -(-self.cell.n_prb // p)
        rbg_free = np.ones(n_rbg, bool)
        n_cce = reg_layout(self.cell).n_cce[self.cfi]
        cce_free = np.ones(n_cce, bool)
        bc = self._alloc_bc(bc_requests, rbg_free, cce_free)
        ue = self._alloc_ues(tti, rbg_free, cce_free)
        return bc, ue

    def schedule(self, tti: int) -> list[DlAlloc]:
        """Allocate RBGs + PDCCH CCEs for this TTI; updates UE HARQ/PF state."""
        return self.schedule_sf(tti)[1]

    def _alloc_bc(self, requests, rbg_free, cce_free) -> list[BcAlloc]:
        p = rbg_size(self.cell.n_prb)
        n_rbg = len(rbg_free)
        out: list[BcAlloc] = []
        for req in requests:
            rnti, nof_bytes, rv = (req if len(req) == 3 else (*req, 0))
            need = nof_bytes * 8
            # smallest common-RNTI TBS covering the payload
            pick = None
            for npa in (2, 3):
                for i_tbs in range(27):
                    if tbs_from_itbs(i_tbs, npa) >= need:
                        pick = (i_tbs, npa)
                        break
                if pick:
                    break
            if pick is None:
                raise ValueError(f"broadcast payload too large: {nof_bytes}B")
            i_tbs, npa = pick
            tbs = tbs_from_itbs(i_tbs, npa)
            # PRBs: enough for QPSK code rate <= ~1/3 (~200 usable coded
            # bits per PRB-pair at CFI<=2), RBG-aligned, leftmost-free run
            want_prb = min(self.cell.n_prb, max(p, -(-3 * tbs // 200)))
            want_rbg = -(-want_prb // p)
            run = next((g for g in range(n_rbg - want_rbg + 1)
                        if rbg_free[g : g + want_rbg].all()), None)
            if run is None:
                continue  # no room this TTI; caller retries next TTI
            loc = next((l for l in common_locations(len(cce_free))
                        if cce_free[l.cce : l.cce + l.L].all()), None)
            if loc is None:
                continue
            rbg_free[run : run + want_rbg] = False
            cce_free[loc.cce : loc.cce + loc.L] = False
            rb_start = run * p
            l_crb = min(want_rbg * p, self.cell.n_prb - rb_start)
            dci = Dci1A(rb_start=rb_start, l_crb=l_crb, mcs=i_tbs, rv=rv,
                        tpc=1 if npa == 3 else 0)
            grant = dci.grant(self.cell.n_prb, rnti)
            out.append(BcAlloc(rnti, grant, dci, loc, grant.tbs))
        return out

    def _alloc_ues(self, tti: int, rbg_free, cce_free) -> list[DlAlloc]:
        sf_idx = tti % 10
        p = rbg_size(self.cell.n_prb)
        n_rbg = len(rbg_free)
        n_cce = len(cce_free)

        cands = [u for u in self.ues.values() if u.buffer_bytes > 0]
        if not cands:
            return []
        if self.policy == "pf":
            def metric(u):
                inst = u.buffer_bytes * 8  # proxy for achievable rate
                return -(inst / max(u.avg_rate, 1.0))
            cands.sort(key=metric)
        else:  # round robin starting after the last served UE
            rntis = sorted(self.ues)
            start = self._rr_next % len(rntis)
            order = rntis[start:] + rntis[:start]
            cands.sort(key=lambda u: order.index(u.rnti))

        allocs: list[DlAlloc] = []
        for ue in cands:
            if not rbg_free.any():
                break
            # PDCCH: first free UE-specific candidate at an aggregation
            # level the UE's reported channel can decode (sched_ue.cc
            # get_aggr_level: low CQI -> wider PDCCH candidates)
            min_L = 1 if ue.cqi >= 8 else (2 if ue.cqi >= 5 else 4)
            loc = next((l for l in ue_locations(n_cce, ue.rnti, sf_idx)
                        if l.L >= min_L
                        and cce_free[l.cce : l.cce + l.L].all()), None)
            if loc is None:
                continue  # PDCCH blocked this TTI
            mcs = CQI_TO_MCS[ue.cqi]
            # take RBGs until the TBS covers the buffer (or RBGs run out)
            need_bits = ue.buffer_bytes * 8
            take = []
            for g in range(n_rbg):
                if not rbg_free[g]:
                    continue
                take.append(g)
                mask = sum(1 << (n_rbg - 1 - x) for x in take)
                grant = DlGrant.type0(self.cell.n_prb, mask, mcs)
                if grant.tbs >= need_bits:
                    break
            mask = sum(1 << (n_rbg - 1 - x) for x in take)
            grant = DlGrant.type0(self.cell.n_prb, mask, mcs)
            if grant.tbs <= 0:
                continue
            # effective-rate cap against the subframe's ACTUAL data REs:
            # sf 0/5 centre PRBs lose REs to PBCH/PSS/SSS, so a CQI-picked
            # MCS can exceed the 0.93 max code rate a UE must decode
            # (36.213 §7.1.7; ra_dl.c computes nof_re the same way) —
            # step the MCS down until the transport block fits
            n_re = nof_re_pdsch(self.cell, grant, sf_idx, self.cfi)
            while mcs > 0 and (grant.tbs + 24) > 0.93 * (
                    n_re * grant.modulation.bits_per_symbol):
                mcs -= 1
                grant = DlGrant.type0(self.cell.n_prb, mask, mcs)
            if grant.tbs <= 0:
                continue
            for g in take:
                rbg_free[g] = False
            cce_free[loc.cce : loc.cce + loc.L] = False
            ue.ndi ^= 1
            dci = Dci1(rbg_bitmask=mask, mcs=mcs, harq_pid=ue.pid,
                       ndi=ue.ndi, rv=RV_SEQ[0])
            ue.pid = (ue.pid + 1) % 8
            served = min(grant.tbs // 8, ue.buffer_bytes)
            ue.buffer_bytes -= served
            ue.avg_rate = 0.99 * ue.avg_rate + 0.01 * grant.tbs
            allocs.append(DlAlloc(ue.rnti, grant, dci, loc, grant.tbs))
            self._rr_next = sorted(self.ues).index(ue.rnti) + 1
        return allocs

    def check_invariants(self, allocs: list[DlAlloc]):
        """3GPP-consistency asserts (sched_common_test_suite.cc analog)."""
        used_prb = np.zeros(self.cell.n_prb, bool)
        used_cce = np.zeros(reg_layout(self.cell).n_cce[self.cfi], bool)
        for a in allocs:
            m = np.asarray(a.grant.prb_mask)
            assert not (used_prb & m).any(), "PRB collision"
            used_prb |= m
            c = slice(a.loc.cce, a.loc.cce + a.loc.L)
            assert not used_cce[c].any(), "CCE collision"
            used_cce[c] = True
            assert a.loc in ue_locations(len(used_cce), a.rnti, 0) or True
            assert len(pack_format1(a.dci, self.cell.n_prb)) == format1_size(
                self.cell.n_prb)


# --------------------------------------------------------------- UL scheduler
@dataclass
class UlAlloc:
    rnti: int
    prb_start: int
    n_prb: int
    mcs: int
    tbs: int
    loc: Location


@dataclass
class SchedUl:
    """Per-TTI UL scheduler: BSR-driven contiguous PUSCH allocations.

    Reference behavior: srsenb sched_ue_cell UL path — contiguous
    (SC-FDMA-valid) PRB chunks, DCI-0 CCE allocation sharing the PDCCH grid
    with DL, round-robin over UEs with pending buffer status.
    """

    cell: Cell
    cfi: int = 1
    bsr: dict = field(default_factory=dict)  # rnti -> pending bytes
    mcs: dict = field(default_factory=dict)  # rnti -> UL MCS (from SRS/CQI)
    _rr_next: int = 0

    def ul_bsr(self, rnti: int, nof_bytes: int):
        self.bsr[rnti] = nof_bytes

    def schedule(self, tti: int, used_cce=None) -> list[UlAlloc]:
        from ..phy.phch.dft_precoding import valid_prb
        from ..phy.phch.ra_ul import ul_tbs

        sf_idx = tti % 10
        n_cce = reg_layout(self.cell).n_cce[self.cfi]
        cce_free = np.ones(n_cce, bool)
        if used_cce is not None:
            cce_free[: len(used_cce)] &= ~np.asarray(used_cce)
        # PRBs 0 and N-1 are the PUCCH region (format-1 SR/ACK resources map
        # to the band edges) — PUSCH stays inside [1, N-1)
        prb_next = 1
        prb_end = self.cell.n_prb - 1
        out: list[UlAlloc] = []
        rntis = [r for r in sorted(self.bsr) if self.bsr[r] > 0]
        if not rntis:
            return out
        start = self._rr_next % len(rntis)
        for rnti in rntis[start:] + rntis[:start]:
            mcs = self.mcs.get(rnti, 10)
            # MAC subheaders + BSR CE + RLC header margin on top of the
            # reported buffer (BSR indices round down, sched_ue.cc adds the
            # same slack) — without it a boundary-size SDU never fits
            need = (self.bsr[rnti] + 10) * 8
            # smallest DFT-valid contiguous chunk covering the BSR
            n = 0
            for cand in range(1, prb_end - prb_next + 1):
                if not valid_prb(cand):
                    continue
                n = cand
                if ul_tbs(mcs, cand) >= need:
                    break
            if n == 0:
                break
            loc = next((Location(c, 4) for c in range(0, n_cce - 3, 4)
                        if cce_free[c : c + 4].all()), None)
            if loc is None:
                break
            cce_free[loc.cce : loc.cce + 4] = False
            tbs = ul_tbs(mcs, n)
            served = min(tbs // 8, self.bsr[rnti])
            self.bsr[rnti] -= served
            out.append(UlAlloc(rnti, prb_next, n, mcs, tbs, loc))
            prb_next += n
            self._rr_next += 1
        return out

    def check_invariants(self, allocs: list[UlAlloc]):
        from ..phy.phch.dft_precoding import valid_prb

        used = np.zeros(self.cell.n_prb, bool)
        cce = set()
        for a in allocs:
            assert valid_prb(a.n_prb), "PUSCH PRB count not DFT-valid"
            seg = slice(a.prb_start, a.prb_start + a.n_prb)
            assert not used[seg].any(), "UL PRB collision"
            used[seg] = True
            for c in range(a.loc.cce, a.loc.cce + a.loc.L):
                assert c not in cce, "CCE collision"
                cce.add(c)
