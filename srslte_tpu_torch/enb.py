"""eNB application: full-stack composition (srsenb/src/enb.cc equivalent).

Per-TTI loop over real PHY samples: DL subframes carry CRS/PSS/SSS, PBCH,
PCFICH, SIB1 (SI-RNTI), RAR (RA-RNTI), and per-UE PDCCH+PDSCH with MAC PDUs
muxed from SRB0 (RLC TM) / SRB1 (RLC AM + PDCP) / DRB1; UL subframes carry
PRACH (detected to RARs), PUCCH scheduling requests, and granted PUSCH
(msg3, RRC, NAS, user data).  The MME is attached by direct call (the
S1AP-lite boundary).

ALL grants flow through the MAC scheduler (mac/sched.py SchedDl + SchedUl —
sched_grid.cc:154 / mac.cc:598,610 analog): broadcast (SIB/RAR) through the
common-space DCI-1A allocator, UE data through the RBG-bitmap DCI-1
allocator with RLC-buffer-driven sizing, and UL through the BSR-driven
DCI-0 allocator.  UL demand reaches the scheduler the reference way:
PUCCH format-1 scheduling requests when the UE holds no grant, then BSR
control elements piggybacked on PUSCH.

Multi-cell: the eNB serves any number of cells (per-cell PHY + scheduler +
RACH, shared RRC/stack — srsenb's cc_worker-per-carrier layout), enabling
measurement-report-driven intra-eNB handover (rrc_mobility.cc analog):
A3 MeasurementReport -> RRCConnectionReconfiguration with
mobilityControlInfo (dedicated preamble, new C-RNTI) -> contention-free
RACH on the target cell -> ReconfigurationComplete.  RLF recovery:
RRCConnectionReestablishmentRequest (C-RNTI + PCI + ShortMAC-I verified
against the stored context) re-anchors the UE on any of our cells with
PDCP/RLC continuity (srsenb rrc.cc reestablishment path).

Channel conventions shared with UeApp (both sides derive them from the cell
config, like the reference's sib/rr configs): CFI 2, PRACH in subframes with
tti % 10 == 1, msg3 grant fixed (carried in the RAR), SR opportunities at
tti % 10 == 3 on PUCCH resource n_pucch = ue_id.

HARQ feedback: every scheduled DL TB expects ACK/NACK 4 TTIs later —
PUCCH 1a at n_pucch = N_PUCCH_1 + n_cce (phy/phch/pucch_proc resources),
or muxed into a simultaneous PUSCH as UCI; low correlation reads as DTX
(with the ACK-moved-to-SR-resource hypothesis checked first).  NACKed TBs
requeue through the scheduler's 1A path as adaptive retransmissions, with
RLC AM as the backstop for DTX.

The subframes are tensors on the app's device (`device=None`: the CUDA
device, raising when there is none).  The host reads the device where the
control flow needs a value: PUSCH CRCs and the UCI ACK, the PUCCH ACK bits,
metrics and SR decisions, and the PRACH detections and timing offsets.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ._device import as_tensor, resolve
from .mac.pdu import DL_LCID, UL_LCID, MacPdu
from .mac.proc import bsr_bytes
from .mac.ra import EnbRach
from .mac.sched import SchedDl, SchedUl
from .pdcp import PdcpConfig, PdcpEntity
from .phy.common.params import Cell
from .phy.enb.enb_dl import EnbDl
from .phy.enb.enb_ul import EnbUl
from .phy.phch.dci import Dci0, Dci1A, pack_format0, pack_format1a
from .phy.phch.pbch import Mib
from .phy.phch.pdcch import Location, Pdcch, ue_locations
from .phy.phch.pdsch import Pdsch
from .phy.phch.prach import PrachConfig, prach_detect
from .phy.phch.pucch import Pucch, PucchConfig
from .phy.phch.pusch import Pusch
from .phy.phch.uci import UciCfgUl
from .phy.phch.ra import DlGrant, tbs_from_itbs
from .phy.phch.ra_ul import UlGrant
from .rlc import RlcAm, RlcTm
from .rrc.mobility import short_mac_i
from .rrc.messages import (ConnectionReconfiguration, ConnectionRelease,
                           ConnectionRequest,
                           ConnectionSetup, ConnectionSetupComplete,
                           DlInformationTransfer, MeasConfigA3, Paging,
                           MeasurementReportMsg, MobilityControl,
                           Reestablishment, ReestablishmentComplete,
                           ReestablishmentReject, ReestablishmentRequest,
                           RrcSecurityModeCommand, RrcSecurityModeComplete,
                           Sib1, UlInformationTransfer,
                           ConnectionReconfigurationComplete,
                           rrc_pack, rrc_unpack)

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE
RA_RNTI = 0x0002
CFI = 2
MSG3_GRANT = UlGrant(prb_start=1, n_prb=4, mcs=4)
SR_SF = 3  # SR opportunities at tti % 5 == 3, PUCCH f1 n_pucch = crnti % 12
# N(1)_PUCCH lives in Sib2.n1_pucch_an (broadcast, the live value)
SR_GRANT_BYTES = 64  # nominal demand an SR conveys until a BSR refines it
ACK_DET_THRESH = 0.25  # PUCCH 1a correlation below this reads as DTX
HO_PREAMBLE = 60  # dedicated preamble pool base for contention-free RACH


@dataclass
class EnbUe:
    crnti: int
    pci: int = 0  # serving cell
    srb0: RlcTm = field(default_factory=RlcTm)
    srb1: RlcAm = field(default_factory=RlcAm)
    drb1: RlcAm = field(default_factory=RlcAm)
    pdcp1: PdcpEntity | None = None
    pdcp_drb: PdcpEntity | None = None
    rrc_state: str = "idle"
    ue_id: int = 0
    pending_ce: bytes | None = None  # contention-resolution CE for msg4
    rx_data: list = field(default_factory=list)  # deciphered DRB SDUs
    ho_pending: bool = False  # HO command sent, awaiting CFRA + complete
    ho_target: tuple | None = None  # (target_pci, new_crnti)
    meas_cfg_sent: bool = False


@dataclass
class _Cc:
    """Per-cell carrier state (srsenb cc_worker + per-carrier scheduler)."""

    cell: Cell
    enb_dl: EnbDl
    enb_ul: EnbUl
    prach_cfg: PrachConfig
    rach: EnbRach
    sched_dl: SchedDl
    sched_ul: SchedUl
    pending_rar: bytes | None = None
    ul_expect: dict = field(default_factory=dict)  # tti -> [(crnti, g, m3)]
    # HARQ feedback bookkeeping: tti -> [(crnti, ncce, raw TB bytes)] for
    # PUCCH 1a decode at n_pucch = N_PUCCH_1 + ncce; NACKed TBs queue in
    # dl_retx and are rescheduled through the scheduler's 1A path
    ack_expect: dict = field(default_factory=dict)
    dl_retx: list = field(default_factory=list)  # [(crnti, raw)]
    sfn: int = 0


def _ack_metric(res) -> tuple[int, float]:
    """(ACK bit, metric) of a PUCCH 1a decode, read from the device."""
    both = torch.stack([res["ack"].reshape(-1)[0].to(torch.float32),
                        res["metric"].reshape(-1)[0].to(torch.float32)]).tolist()
    return int(both[0]), both[1]


class EnbApp:
    def __init__(self, cells, mme=None, mcs_dl: int = 5,
                 neighbor_meas: bool = False, s1=None, events=None,
                 tdd=None, sib2=None, device=None):
        from .phy.common.tdd import TddConfig
        from .utils.events import EventLog
        from .rrc.messages import Sib2

        if s1 is not None:
            raise NotImplementedError(
                "EnbApp(s1=...): the S1 wire path (enb_s1) is ROADMAP queue A "
                "step 6b; the co-located Mme is attached by direct call")
        self.device = resolve(device)

        # the broadcast common config IS the live config: PRACH geometry
        # and the PUCCH ACK region derive from it on both ends of the air
        # interface (enb_cfg_parser sib2 -> phy semantics)
        self.sib2 = sib2 or Sib2()

        cells = [cells] if isinstance(cells, Cell) else list(cells)
        # TDD frame structure: one UL/DL configuration for all cells; DL
        # subframes carry the full schedule, special subframes control +
        # UL grants only, UL subframes carry no DL signal at all
        if tdd is None and cells[0].frame_type == "tdd":
            tdd = TddConfig(sf_config=1, ss_config=4)
        self.tdd: TddConfig | None = tdd
        self.events = events if events is not None else EventLog()
        self.ccs: dict[int, _Cc] = {}
        for i, c in enumerate(cells):
            self.ccs[c.id] = _Cc(
                cell=c, enb_dl=EnbDl(c), enb_ul=EnbUl(c),
                prach_cfg=self.sib2.prach_config(c.ofdm),
                rach=EnbRach(next_crnti=0x46 + 0x100 * i),
                sched_dl=SchedDl(c, cfi=CFI), sched_ul=SchedUl(c, cfi=CFI))
            self.events.sector_start(i, c.id, c.id)
        self.cell = cells[0]
        self.mme = mme
        self.mcs_dl = mcs_dl
        self.neighbor_meas = neighbor_meas or len(cells) > 1
        self.ues: dict[int, EnbUe] = {}
        # guti -> set of cell ids that still owe this page
        self._pending_pages: dict[int, set] = {}
        self._next_ue_id = 1
        self._pending_nas: dict = {}

    # -- single-cell compatibility views ----------------------------------
    @property
    def _cc0(self) -> _Cc:
        return self.ccs[self.cell.id]

    def _cc_of(self, pci: int | None) -> _Cc:
        return self.ccs[self.cell.id if pci is None else pci]

    # -- TDD helpers --------------------------------------------------------
    def _sf_type(self, tti: int):
        from .phy.common.tdd import SfType

        if self.tdd is None:
            return SfType.DL
        return self.tdd.sf_type(tti % 10)

    def _prach_sf(self) -> int:
        """PRACH opportunity subframe — FDD: from the broadcast SIB2
        prach-ConfigIndex (36.211 table 5.7.1-2); TDD: the first UL
        subframe, sf1 being the special subframe."""
        return (self.sib2.prach_sf if self.tdd is None
                else self.tdd.ul_subframes()[0])

    def _sr_opportunity(self, tti: int) -> bool:
        if self.tdd is None:
            return tti % 5 == SR_SF
        return tti % 10 in self.tdd.sr_subframes()

    def _next_ul(self, tti: int) -> int:
        return tti if self.tdd is None else self.tdd.next_ul(tti)

    # ---------------- DL ----------------------------------------------------
    def _dl_buffer_bytes(self, ue: EnbUe) -> int:
        """Pending DL bytes for the scheduler (RLC buffer state + CEs)."""
        n = sum(r.get_buffer_state()
                for r in (ue.srb0, ue.srb1, ue.drb1))
        if ue.pending_ce is not None:
            n += 7  # CE + subheader
        return n + (4 if n else 0)  # MAC subheader slack

    def tx_subframe(self, tti: int, pci: int | None = None):
        """The DL subframe of `tti` (a tensor [sf_len] on the device), or
        None in a TDD uplink subframe."""
        from .phy.common.tdd import SfType

        cc = self._cc_of(pci)
        sf = tti % 10
        sft = self._sf_type(tti)
        if sf == 9:
            cc.sfn = (cc.sfn + 1) % 1024
        if sft is SfType.UL:
            return None  # uplink subframe: the eNB transmits nothing
        special = sft is SfType.SPECIAL
        g = cc.enb_dl.put_base(cc.enb_dl.empty_grids(device=self.device), sf)
        if sf == 0:
            g = cc.enb_dl.put_pbch(g, Mib(cc.cell.n_prb, "norm", "1",
                                          cc.sfn))
        g = cc.enb_dl.put_pcfich(g, sf, CFI)

        def put_dlsch(rnti, grant, loc, dci_bits, payload):
            nonlocal g
            pdsch = Pdsch(cc.cell, grant, sf, cfi=CFI, rnti=rnti)
            tbs_bytes = grant.tbs // 8
            if isinstance(payload, MacPdu):
                # pad via an explicit padding subheader so the parser can
                # recover exact SDU lengths (36.321 §6.1.2)
                payload = payload.pack(pdu_len=tbs_bytes)
            if len(payload) > tbs_bytes:
                raise ValueError("DL payload exceeds TBS")
            raw = payload + bytes(tbs_bytes - len(payload))
            bits = np.unpackbits(np.frombuffer(raw, np.uint8))[: grant.tbs]
            g = cc.enb_dl.put_pdcch(g, sf, CFI, dci_bits, rnti, loc)
            g = cc.enb_dl.put_pdsch(g, pdsch, bits)

        # -- broadcast requests for this TTI (bc_sched/ra_sched analog) ------
        # special subframes (TDD DwPTS) carry sync/control + UL grants only
        bc_requests = []
        bc_payloads = {}
        if special:
            bc_allocs, dl_allocs = [], []
        if not special and cc.pending_rar is not None:
            bc_requests.append((RA_RNTI, len(cc.pending_rar), 0))
            bc_payloads[RA_RNTI] = cc.pending_rar
        page_sf = 9 if self.tdd is None else 5  # TDD: sf9 can be uplink
        if not special and tti % 40 == 5:  # SIB1 broadcast window
            sib = rrc_pack(Sib1())
            bc_requests.append((SI_RNTI, len(sib), 0))
            bc_payloads[SI_RNTI] = sib
        elif not special and tti % 20 == 15:  # SIB2 SI window
            si = rrc_pack(self.sib2)
            bc_requests.append((SI_RNTI, len(si), 0))
            bc_payloads[SI_RNTI] = si
        if (not special and self._pending_pages
                and tti % 10 == page_sf):  # paging occasion
            # page on EVERY cell: an idle UE may have reselected to any of
            # our sectors (the reference's paging goes to all cells of the
            # tracking area, s1ap_paging_proc)
            recs = tuple(gu for gu, left in self._pending_pages.items()
                         if cc.cell.id in left)
            if recs:
                pcch = rrc_pack(Paging(records=recs))
                bc_requests.append((P_RNTI, len(pcch), 0))
                bc_payloads[P_RNTI] = pcch
                for gu in recs:
                    self._pending_pages[gu].discard(cc.cell.id)
                self._pending_pages = {gu: left for gu, left
                                       in self._pending_pages.items() if left}
        retx_rnti = None
        if not special and cc.dl_retx:
            # NACKed TBs: adaptive HARQ retransmission as C-RNTI 1A
            # allocations through the scheduler's common path (one TB/TTI).
            # TBs beyond the common-space TBS ceiling fall back to RLC AM
            # recovery rather than crashing the allocator.
            crnti, raw = cc.dl_retx.pop(0)
            if crnti in self.ues and len(raw) * 8 <= tbs_from_itbs(26, 3):
                bc_requests.append((crnti, len(raw), 0))
                bc_payloads[crnti] = raw
                retx_rnti = crnti

        # -- DL buffer states into the scheduler -----------------------------
        for crnti, ue in self.ues.items():
            if ue.pci != cc.cell.id or crnti != ue.crnti:
                continue
            if crnti not in cc.sched_dl.ues:
                cc.sched_dl.add_ue(crnti)
            # during handover only control (the HO command on SRB1) drains;
            # DRB data is held until ReconfigurationComplete on the target
            n = ue.srb0.get_buffer_state() + ue.srb1.get_buffer_state()
            if not ue.ho_pending:
                n += ue.drb1.get_buffer_state()
            if ue.pending_ce is not None:
                n += 7
            if crnti == retx_rnti:
                n = 0  # one DL assignment per UE per TTI (36.213): the
                # retransmission occupies this UE's slot this subframe
            cc.sched_dl.buffer_state(crnti, n + (4 if n else 0))

        if not special:
            bc_allocs, dl_allocs = cc.sched_dl.schedule_sf(tti, bc_requests)
            cc.sched_dl.check_invariants(dl_allocs)

        for a in bc_allocs:
            put_dlsch(a.rnti, a.grant, a.loc,
                      pack_format1a(a.dci, cc.cell.n_prb),
                      bc_payloads[a.rnti])
            if a.rnti == RA_RNTI:
                # msg3 PUSCH 4 TTIs out for the RAR's C-RNTI (grant carried
                # in the RAR payload; TDD: first UL subframe from there)
                crnti = cc.rach.last_rar_crnti
                t3 = self._next_ul(tti + 4)
                cc.ul_expect.setdefault(t3, []).append(
                    (crnti, MSG3_GRANT, True))
                cc.pending_rar = None

        # -- per-UE DL data: mux MAC PDUs to the scheduled TBS ---------------
        from .phy.phch.dci import pack_format1

        for a in dl_allocs:
            ue = self.ues[a.rnti]
            tbs_bytes = a.grant.tbs // 8
            pdu = MacPdu()
            n = 0
            if ue.pending_ce is not None:
                pdu.add_ce(int(DL_LCID.CON_RES_ID), ue.pending_ce)
                ue.pending_ce = None
                n += 1
            bearers = ((0, ue.srb0), (1, ue.srb1)) if ue.ho_pending else \
                ((0, ue.srb0), (1, ue.srb1), (3, ue.drb1))
            # sequential budget: each subPDU costs its payload plus a <=3
            # byte MAC subheader (mac_sch_pdu assembly in the reference);
            # a blanket margin would starve RLC at small TBS and stall the
            # tail segment of an SRB message forever
            used = 7 if n else 0  # contention-resolution CE + subheader
            for lcid, rlc in bearers:
                avail = tbs_bytes - used - 3
                if avail >= 3 and rlc.get_buffer_state() > 0:
                    sdu = rlc.read_pdu(avail)
                    if sdu:
                        pdu.add_sdu(lcid, sdu)
                        used += len(sdu) + 3
                        n += 1
            if not n:
                continue
            raw = pdu.pack(pdu_len=tbs_bytes)
            put_dlsch(a.rnti, a.grant, a.loc,
                      pack_format1(a.dci, cc.cell.n_prb), raw)
            # expect HARQ feedback on PUCCH 1a (FDD: tti+4; TDD: next UL sf)
            cc.ack_expect.setdefault(self._next_ul(tti + 4), []).append(
                (a.rnti, a.loc.cce, raw))

        # -- UL grants: BSR/SR-driven through SchedUl ------------------------
        # TDD: a DCI0 in this subframe schedules PUSCH k_pusch TTIs out
        # (36.213 table 8-2); subframes with k=0 carry no UL grants
        k_ul = 4 if self.tdd is None else self.tdd.k_pusch(sf)
        if k_ul:
            used_cce = np.zeros(Pdcch(cc.cell, CFI, sf).n_cce, bool)
            for a in bc_allocs + dl_allocs:
                used_cce[a.loc.cce : a.loc.cce + a.loc.L] = True
            for a in cc.sched_ul.schedule(tti, used_cce=used_cce):
                dci0 = Dci0(rb_start=a.prb_start, l_crb=a.n_prb,
                            mcs_rv=a.mcs)
                g = cc.enb_dl.put_pdcch(g, sf, CFI,
                                        pack_format0(dci0, cc.cell.n_prb),
                                        a.rnti, a.loc)
                cc.ul_expect.setdefault(tti + k_ul, []).append(
                    (a.rnti, UlGrant(a.prb_start, a.n_prb, a.mcs), False))

        if special:
            # silence the GP + UpPTS symbols: the eNB transmits only the
            # DwPTS portion of a special subframe (36.211 table 4.2-1)
            nsym = cc.cell.ofdm.nsymb_sf
            mask = torch.as_tensor((np.arange(nsym) < self.tdd.nof_dw)
                                   .astype(np.float32))[:, None].to(self.device)
            g = g * mask
        return cc.enb_dl.gen_signal(g)[..., 0, :]

    # ---------------- UL ----------------------------------------------------
    def rx_subframe(self, samples, tti: int, pci: int | None = None):
        """samples: PRACH window (tti%10==1), PUCCH/PUSCH subframe, or None;
        a tensor or host samples, taken to the app's device."""
        cc = self._cc_of(pci)
        is_last_cc = pci is None or pci == list(self.ccs)[-1]
        if samples is None:
            cc.ack_expect.pop(tti, None)  # no UL this TTI: feedback is DTX
            if is_last_cc:
                self._tick()
            return
        samples = as_tensor(samples, self.device)
        expected = cc.ul_expect.pop(tti, [])
        acks = cc.ack_expect.pop(tti, [])
        served = {c for c, _, _ in expected}
        # the PUCCH region is demodulated at most ONCE per TTI; every
        # ACK/SR hypothesis decodes against the same cached grid
        _grid_cache = []

        def pucch_grid():
            if not _grid_cache:
                _grid_cache.append(cc.enb_ul.ofdm.rx_sf(samples))
            return _grid_cache[0]
        # -- HARQ feedback: PUCCH 1a at n_pucch = N_PUCCH_1 + ncce ----------
        for crnti, ncce, raw in acks:
            ue = self.ues.get(crnti)
            if ue is None or crnti in served or ue.rrc_state == "idle":
                continue  # feedback rode PUSCH / UE gone: no PUCCH here
            res = Pucch(cc.cell,
                        PucchConfig("1a", n_pucch=self.sib2.n1_pucch_an
                                    + ncce),
                        sf_idx=tti % 10).decode(pucch_grid())
            bit, metric = _ack_metric(res)
            if metric < ACK_DET_THRESH:
                # DTX on the dynamic resource: a simultaneous positive SR
                # moves the ACK onto the SR resource (36.213 §10.1)
                res = Pucch(cc.cell,
                            PucchConfig("1a", n_pucch=crnti % 12),
                            sf_idx=tti % 10).decode(pucch_grid())
                bit, metric = _ack_metric(res)
                if metric < ACK_DET_THRESH:
                    continue  # true DTX: leave recovery to RLC AM
                cc.sched_ul.ul_bsr(crnti, max(cc.sched_ul.bsr.get(crnti, 0),
                                              SR_GRANT_BYTES))
            if bit == 0:
                cc.dl_retx.append((crnti, raw))
        if tti % 10 == self._prach_sf() and not expected:
            det, metric, toff = prach_detect(cc.prach_cfg, samples)
            det = det.cpu().numpy()
            if det.any():
                idx = np.where(det)[0].tolist()
                toff = toff.cpu().numpy()
                tas = [int(toff[i]) for i in idx]
                cc.pending_rar = cc.rach.rach_detected(idx, tas)
            if is_last_cc:
                self._tick()
            return
        ack_by_rnti = {c: (ncce, raw) for c, ncce, raw in acks}
        for crnti, grant, is_msg3 in expected:
            # a pending HARQ-ACK for this UE rides the PUSCH as muxed UCI
            ue = self.ues.get(crnti)
            with_uci = (not is_msg3 and crnti in ack_by_rnti
                        and ue is not None and ue.rrc_state != "idle")
            pusch = Pusch(cc.cell, grant, tti % 10, rnti=crnti,
                          uci=UciCfgUl(o_ack=1) if with_uci else None)
            bits, ok, info = cc.enb_ul.decode_pusch(samples, pusch)
            ok = bool(ok)
            if with_uci and ok:
                if int(info["ack"].reshape(-1)[0]) == 0:
                    cc.dl_retx.append((crnti, ack_by_rnti[crnti][1]))
            if not ok:
                continue
            raw = np.packbits(bits.cpu().numpy()).tobytes()
            if is_msg3:
                self._handle_msg3(cc, crnti, raw)
            else:
                self._handle_ul_mac(cc, crnti, raw)
        if self._sr_opportunity(tti):
            # scheduling requests: PUCCH format 1 per connected UE (skip UEs
            # that transmitted PUSCH in this same subframe)
            served = {c for c, _, _ in expected}
            for crnti, ue in self.ues.items():
                if (ue.pci != cc.cell.id or crnti != ue.crnti
                        or crnti in served
                        or ue.rrc_state == "idle" or ue.ho_pending):
                    continue
                pucch = Pucch(cc.cell,
                              PucchConfig("1", n_pucch=crnti % 12),
                              sf_idx=tti % 10)
                res = pucch.decode(pucch_grid())
                if bool(res["detected"]):
                    cc.sched_ul.ul_bsr(
                        crnti, max(cc.sched_ul.bsr.get(crnti, 0),
                                   SR_GRANT_BYTES))
        if is_last_cc:
            self._tick()

    def _tick(self):
        for ue in self.ues.values():
            ue.srb1.tick()
            ue.drb1.tick()

    # ---------------- stack ----------------------------------------------
    def _handle_msg3(self, cc: _Cc, crnti: int, raw: bytes):
        ue = self.ues.get(crnti)
        if ue is not None and ue.ho_pending:
            # contention-free handover msg3: SRB1 data (Reconfiguration
            # Complete), no contention resolution (36.321 5.1.5).  The UE
            # has arrived on the target cell: re-key the context now.
            target_pci, new_crnti = ue.ho_target
            if crnti == new_crnti and ue.crnti != new_crnti:
                src = self.ccs[ue.pci]
                src.sched_dl.ues.pop(ue.crnti, None)
                src.sched_ul.bsr.pop(ue.crnti, None)
                self.ues.pop(ue.crnti, None)
                ue.crnti = new_crnti
                ue.pci = target_pci
            self._handle_ul_mac(cc, crnti, raw)
            return
        if cc.rach.rx_msg3(crnti, raw) is None:
            return
        mac3 = MacPdu.parse(raw, ul=True)
        ccch = next((s for s in mac3.subpdus
                     if s.lcid == int(UL_LCID.CCCH)), None)
        if ccch is None:
            return
        req = rrc_unpack(ccch.payload, "ul_ccch")
        if isinstance(req, ReestablishmentRequest):
            self._handle_reestablishment(cc, crnti, ccch.payload, req)
            return
        assert isinstance(req, ConnectionRequest)
        ue = EnbUe(crnti=crnti, pci=cc.cell.id, ue_id=self._next_ue_id)
        self._next_ue_id += 1
        self.ues[crnti] = ue
        # msg4: contention-resolution CE (echo of the CCCH SDU head) +
        # ConnectionSetup on SRB0
        ue.pending_ce = ccch.payload[:6].ljust(6, b"\0")
        ue.srb0.write_sdu(rrc_pack(ConnectionSetup()))
        ue.rrc_state = "setup"

    def _handle_reestablishment(self, cc: _Cc, new_crnti: int,
                                ccch_payload: bytes,
                                req: ReestablishmentRequest):
        """rrc.cc reestablishment: find the old context by (C-RNTI, PCI),
        verify ShortMAC-I, re-anchor on this cell with bearer continuity."""
        old = self.ues.get(req.c_rnti)
        ok = (old is not None and old.pci == req.pci
              and old.pdcp1 is not None)
        if ok:
            expect = short_mac_i(old.pdcp1.k_int, old.pdcp1.cfg.ia,
                                 Sib1().cell_id, req.pci, req.c_rnti)
            ok = expect == req.short_mac_i
        reply_ue = old if ok else EnbUe(crnti=new_crnti, pci=cc.cell.id)
        if ok:
            # move the context: new C-RNTI, possibly new serving cell
            src = self.ccs[old.pci]
            src.sched_dl.ues.pop(old.crnti, None)
            src.sched_ul.bsr.pop(old.crnti, None)
            del self.ues[old.crnti]
            if old.ho_target is not None:  # abandoned HO: drop the alias
                alias = old.ho_target[1]
                if alias != new_crnti:
                    self.ues.pop(alias, None)
                old.ho_target = None
            old.crnti = new_crnti
            old.pci = cc.cell.id
            old.ho_pending = False
            self.ues[new_crnti] = old
            old.pending_ce = ccch_payload[:6].ljust(6, b"\0")
            old.srb0.write_sdu(rrc_pack(Reestablishment()))
            old.rrc_state = "reestablishing"
        else:
            self.ues[new_crnti] = reply_ue
            reply_ue.pending_ce = ccch_payload[:6].ljust(6, b"\0")
            reply_ue.srb0.write_sdu(rrc_pack(ReestablishmentReject()))

    def _handle_ul_mac(self, cc: _Cc, crnti: int, raw: bytes):
        ue = self.ues.get(crnti)
        if ue is None:
            return
        pdu = MacPdu.parse(raw, ul=True)
        for s in pdu.subpdus:
            if s.lcid == 1:
                ue.srb1.write_pdu(s.payload)
            elif s.lcid == 3:
                ue.drb1.write_pdu(s.payload)
            elif s.lcid in (int(UL_LCID.SHORT_BSR), int(UL_LCID.TRUNC_BSR)):
                idx = s.payload[0] & 0x3F
                cc.sched_ul.ul_bsr(crnti, bsr_bytes(idx) if idx else 0)
        # drain SRB1 -> (PDCP) -> RRC
        for sdu in ue.srb1.rx_sdus[:]:
            ue.srb1.rx_sdus.remove(sdu)
            if ue.pdcp1 is not None:
                sdu = ue.pdcp1.rx(sdu)
                if sdu is None:
                    continue
            self._handle_rrc_ul(ue, sdu)
        # drain DRB1 -> PDCP decipher -> user plane
        for sdu in ue.drb1.rx_sdus[:]:
            ue.drb1.rx_sdus.remove(sdu)
            if ue.pdcp_drb is not None:
                pkt = ue.pdcp_drb.rx(sdu)
                if pkt is not None:
                    ue.rx_data.append(pkt)

    def page(self, guti: int):
        """Queue a PCCH page for the next paging occasion on every cell
        (the MME's paging trigger when DL data arrives for an idle UE)."""
        self._pending_pages[guti] = set(self.ccs)

    def release_connection(self, ue: EnbUe):
        """Send RRCConnectionRelease on SRB1 and drop the context after
        the message drains (36.331 5.3.8)."""
        if ue.pdcp1 is not None:
            ue.srb1.write_sdu(ue.pdcp1.tx(rrc_pack(ConnectionRelease())))
        ue.rrc_state = "releasing"

    def release_ue(self, ue: EnbUe):
        src = self.ccs.get(ue.pci)
        if src is not None:
            src.sched_dl.ues.pop(ue.crnti, None)
            src.sched_ul.bsr.pop(ue.crnti, None)
        self.ues.pop(ue.crnti, None)
        self.events.rrc_event(0, ue.crnti, "released")

    def send_data(self, crnti: int, packet: bytes):
        """Queue a DL user-plane packet (SGi -> DRB path)."""
        ue = self.ues[crnti]
        ue.drb1.write_sdu(ue.pdcp_drb.tx(packet))

    def _activate_as_security(self, ue: EnbUe):
        """AS keys from K_eNB (S1AP InitialContextSetup carries it in the
        reference; here it comes from the co-located MME)."""
        from .nas.keys import kdf_as_keys, kdf_kenb
        from .security import EEA2, EIA2

        kenb = kdf_kenb(self.mme.ues[ue.ue_id].kasme, 0)
        k_up, k_rrc_int = kdf_as_keys(kenb, EEA2, EIA2)
        ue.pdcp1 = PdcpEntity(PdcpConfig(is_srb=True, bearer_id=1, ea=EEA2,
                                         ia=EIA2), kenb[:16], k_rrc_int,
                              is_ue=False)
        ue.pdcp_drb = PdcpEntity(PdcpConfig(is_srb=False, bearer_id=1,
                                            ea=EEA2), k_up, is_ue=False)

    # ---------------- mobility (rrc_mobility.cc analog) -------------------
    def _start_handover(self, ue: EnbUe, report: MeasurementReportMsg):
        """A3 report -> intra-eNB handover to the strongest neighbor that
        is one of our cells (rrc_mobility.cc:handle_ue_meas_report).

        The context stays keyed by the source C-RNTI (the HO command still
        drains via the source cell's RLC/scheduler) and is ALSO aliased
        under the new C-RNTI; the switch happens when the contention-free
        msg3 arrives on the target cell."""
        targets = [(dbm, pci) for pci, dbm in (report.neighbors or {}).items()
                   if pci in self.ccs and pci != ue.pci]
        if not targets or ue.ho_pending:
            return
        _, target_pci = max(targets)
        tgt = self.ccs[target_pci]
        new_crnti = tgt.rach.next_crnti
        tgt.rach.next_crnti += 1
        tgt.rach.reserve(HO_PREAMBLE, new_crnti)
        mci = MobilityControl(target_pci=target_pci, new_crnti=new_crnti,
                              t304_ms=200, ra_preamble=HO_PREAMBLE)
        ue.srb1.write_sdu(ue.pdcp1.tx(rrc_pack(
            ConnectionReconfiguration(drb_id=0, mobility=mci))))
        ue.ho_pending = True
        ue.ho_target = (target_pci, new_crnti)
        self.ues[new_crnti] = ue  # alias until msg3 lands on the target

    def _handle_rrc_ul(self, ue: EnbUe, raw: bytes):
        msg = rrc_unpack(raw, "ul_dcch")
        if isinstance(msg, ConnectionSetupComplete):
            ue.rrc_state = "connected"
            self.events.rrc_event(0, ue.crnti, "connected")
            self._nas_dl(ue, msg.nas_pdu)
        elif isinstance(msg, UlInformationTransfer):
            self._nas_dl(ue, msg.nas_pdu)
        elif isinstance(msg, RrcSecurityModeComplete):
            ue.rrc_state = "secure"
            self._activate_as_security(ue)
            recfg = ConnectionReconfiguration(
                drb_id=1, nas_pdu=self._pending_nas.pop(ue.crnti, b""),
                meas=MeasConfigA3(a3_offset_db=3.0)
                if self.neighbor_meas else None)
            ue.meas_cfg_sent = recfg.meas is not None
            ue.srb1.write_sdu(ue.pdcp1.tx(rrc_pack(recfg)))
        elif isinstance(msg, ConnectionReconfigurationComplete):
            ue.rrc_state = "rrc_reconfigured"
            if ue.ho_pending:
                self.events.rrc_event(0, ue.crnti, "handover")
            ue.ho_pending = False
            ue.ho_target = None
        elif isinstance(msg, MeasurementReportMsg):
            self.events.measurement_report(0, ue.crnti)
            # link adaptation: an A3 report means the serving link is weak
            # and interference-limited — drop to robust MCS and force wide
            # PDCCH aggregation so the HO command survives (the reference
            # reaches the same state via the UE's falling CQI reports,
            # sched_ue.cc get_aggr_level/cqi_to_mcs)
            sched = self.ccs[ue.pci].sched_dl
            if ue.crnti in sched.ues:
                sched.ues[ue.crnti].cqi = min(sched.ues[ue.crnti].cqi, 3)
            self._start_handover(ue, msg)
        elif isinstance(msg, ReestablishmentComplete):
            ue.rrc_state = "connected"
            self.events.rrc_event(0, ue.crnti, "reestablished")
            # re-add the DRB so the data path resumes on the new cell
            ue.srb1.write_sdu(ue.pdcp1.tx(rrc_pack(
                ConnectionReconfiguration(drb_id=1))))

    def _nas_dl(self, ue: EnbUe, nas_pdu: bytes):
        if not nas_pdu:
            return
        if self.mme is None:
            return
        for dl in self.mme.rx_nas(ue.ue_id, nas_pdu):
            # when NAS reaches "attached", run RRC security then carry the
            # AttachAccept inside the ConnectionReconfiguration (as the
            # reference piggybacks it)
            ctx = self.mme.ues[ue.ue_id]
            if ctx.state == "attached" and ue.rrc_state == "connected":
                self._pending_nas[ue.crnti] = dl
                ue.srb1.write_sdu(rrc_pack(RrcSecurityModeCommand(
                    self.mme.ea, self.mme.ia)))
            else:
                ue.srb1.write_sdu(rrc_pack(DlInformationTransfer(nas_pdu=dl)))
