"""UE application: full-stack composition (srsue/src/ue.cc equivalent).

Per-TTI receive path over real PHY samples: MIB (sf0), SIB1 (SI-RNTI),
RAR (RA-RNTI), C-RNTI PDCCH blind search for DL assignments (DCI 1A) and UL
grants (DCI 0); DL-SCH MAC demux -> SRB0/SRB1/DRB RLC -> PDCP -> RRC/NAS;
UL path builds PRACH and granted PUSCH subframes (msg3, RRC, NAS, data).

Conventions shared with EnbApp: CFI 2, PRACH at tti % 10 == 1, msg3 grant
fixed (carried in the RAR), PUSCH 4 TTIs after the grant, SR opportunities
at tti % 10 == 3 on PUCCH format 1 resource n_pucch = crnti % 12.  UL-SCH
PDUs piggyback a short BSR control element so the eNB scheduler tracks the
remaining uplink demand (BSR-driven SchedUl).

Every decoded DL assignment is answered with HARQ ACK/NACK 4 TTIs later:
PUCCH format 1a at the pucch_proc-derived resource (dynamic n_cce +
N_PUCCH_1, or the SR resource on a simultaneous positive SR), or muxed
into a granted PUSCH as UCI (dl_harq.cc ack path analog).

The samples are tensors on the app's device (`device=None`: the CUDA device,
raising when there is none).  The host reads the device where the control
flow needs a value: the MIB and PDSCH CRCs, the blind searches' hits, the
SNR for radio-link monitoring and the neighbour RSRPs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from ._device import as_tensor, resolve
from .mac.pdu import DL_LCID, UL_LCID, MacPdu
from .mac.proc import short_bsr_ce
from .mac.ra import UeRaProc
from .nas.keys import kdf_as_keys, kdf_kenb
from .pdcp import PdcpConfig, PdcpEntity
from .phy.common.params import Cell
from .phy.phch.dci import (format0_1a_size, format1_size, format1c_size,
                           unpack_format0, unpack_format1, unpack_format1a,
                           unpack_format1c)
from .phy.phch.pbch import Mib
from .phy.phch.pdcch import Pdcch
from .phy.phch.pdsch import Pdsch
from .phy.phch.prach import PrachConfig, prach_gen
from .phy.phch.pucch import Pucch, PucchConfig
from .phy.phch.pucch_proc import (AckCfg, PucchProcCfg, UciUsage, get_npucch,
                                  select_format)
from .phy.phch.pusch import Pusch
from .phy.phch.uci import UciCfgUl
from .phy.phch.ra_ul import UlGrant
from .phy.ue.ue_dl import UeDl
from .phy.ue.ue_mib import UeMib
from .phy.ue.ue_ul import UeUl
from .phy.ue.intra_measure import IntraMeasure
from .rlc import RlcAm, RlcTm
from .rrc.meas import MeasEventEngine, ReportConfig
from .rrc.mobility import RadioLinkMonitor, RlmConfig, short_mac_i
from .rrc.messages import (ConnectionReconfiguration, Sib2,
                           ConnectionReconfigurationComplete,
                           ConnectionRelease, ConnectionRequest,
                           ConnectionSetup, ConnectionSetupComplete,
                           DlInformationTransfer, MeasurementReportMsg,
                           Paging, Reestablishment,
                           ReestablishmentComplete, ReestablishmentReject,
                           ReestablishmentRequest, RrcSecurityModeCommand,
                           RrcSecurityModeComplete, Sib1,
                           UlInformationTransfer, rrc_pack, rrc_unpack)
from .security import EEA2, EIA2
from .ue_stack import UeNas

SI_RNTI = 0xFFFF
P_RNTI = 0xFFFE
RA_RNTI = 0x0002
CFI = 2
MSG3_GRANT = UlGrant(prb_start=1, n_prb=4, mcs=4)
SR_SF = 3  # SR opportunities at tti % 5 == 3 (sr-ConfigIndex period-5 analog)
N_PUCCH_1 = 12  # N(1)_PUCCH: dynamic-ACK region starts above the SR resources
QHYST_DB = 3.0  # 36.304 Qhyst: reselection ranking hysteresis
T_RESEL_MS = 40  # 36.304 Treselection (scaled to the test timeline)
MEAS_PERIOD_MS = 5  # intra-frequency measurement cadence
RSRP_REF_DBM = -60.0  # virtual-RF calibration: unit linear power -> -60 dBm


@dataclass
class UlTx:
    tti: int
    kind: str  # "prach" | "pusch"
    grant: UlGrant | None = None
    payload: bytes = b""
    preamble: int = 0


@functools.lru_cache(maxsize=None)
def _ue_mib(cell_id: int, n_prb: int) -> UeMib:
    """One MIB decoder per cell: its modem, estimator and decoder keep their
    host tables between the subframe-0 attempts."""
    return UeMib(cell_id, n_prb)


@functools.lru_cache(maxsize=None)
def _pdcch(cell: Cell, cfi: int, sf: int) -> Pdcch:
    """One PDCCH processor per (cell, cfi, subframe): its scrambling
    sequences are built on the host once."""
    return Pdcch(cell, cfi, sf)


class UeApp:
    def __init__(self, cell: Cell, nas: UeNas, neighbor_pcis: tuple = (),
                 rlm_cfg: RlmConfig | None = None, tdd=None, identity=None,
                 device=None):
        """identity: the 4 random bytes of the ConnectionRequest's UE
        identity; None derives them from id(self), as the JAX package's
        UeApp does."""
        from .phy.common.tdd import TddConfig

        self.device = resolve(device)
        if identity is not None and len(identity) != 4:
            raise ValueError(f"identity must be 4 bytes, got {len(identity)}")
        self.identity = identity
        self.cell = cell
        self.nas = nas
        # TDD frame structure (cc_worker set_tdd_config analog): per-tti
        # direction, PRACH on the first UL subframe, table-8-2 grant delays
        if tdd is None and cell.frame_type == "tdd":
            tdd = TddConfig(sf_config=1, ss_config=4)
        self.tdd: TddConfig | None = tdd
        self.ue_dl = UeDl(cell)
        self.ue_ul = UeUl(cell)
        self.prach_cfg = PrachConfig(cell.ofdm, zero_corr_cfg=7)
        self.ra = UeRaProc()
        self.state = "mib"
        self.mib: Mib | None = None
        self.sib1: Sib1 | None = None
        self.sib2 = None  # 36.331 SIB2: live PRACH/PUCCH common config
        self.n_pucch_1 = N_PUCCH_1  # overridden by SIB2 n1_pucch_an
        self.crnti = 0
        self.srb0 = RlcTm()
        self.srb1 = RlcAm()
        self.drb1 = RlcAm()
        self.pdcp1: PdcpEntity | None = None
        self.pdcp_drb: PdcpEntity | None = None
        self.rrc_state = "idle"
        self.paged = 0
        self.pending_ul: dict[int, UlTx] = {}
        # HARQ feedback: tti -> (ncce of the DL assignment's PDCCH, ack bit);
        # transmitted on PUCCH 1a at n_pucch = N_PUCCH_1 + ncce (36.213
        # §10.1, resource/format via phy.phch.pucch_proc)
        self.pending_ack: dict[int, tuple] = {}
        self.rx_data: list = []
        self._ccch_sdu = b""
        # mobility state (sync.cc RLM + rrc_meas.cc + rrc.cc mobility)
        self.known_pcis = {cell.id, *neighbor_pcis}
        self.rlm = RadioLinkMonitor(rlm_cfg or RlmConfig())
        self.meas_engine: MeasEventEngine | None = None
        # measure serving + neighbors with ONE batched measurer so the A3
        # comparison uses a consistent RSRP scale
        self._measurer = (IntraMeasure(cell.n_prb,
                                       tuple(sorted(self.known_pcis)))
                          if len(self.known_pcis) > 1 else None)
        self._last_neighbors: dict = {}
        self._serving_dbm = -141.0
        self.t304 = -1  # handover supervision countdown (ms)
        self._ho_fallback: tuple | None = None  # (old_pci, old_crnti)
        self._ded_preamble = -1
        self._ra_mode = "attach"  # what msg3's CCCH SDU carries
        self._reest_req = b""
        self._cell_switched = False
        self.ho_count = 0
        self.reest_count = 0
        self._muted_pcis: frozenset = frozenset()
        self._crs_mute = None  # active FeICIC CRS-muting mask (or None)
        self._resel_ms = 0  # 36.304 Treselection accumulator (idle mode)
        self._resel_target = None  # candidate the accumulator is counting for
        self.reselect_count = 0
        # uplink TFT classifier (tft_packet_filter.cc): filters installed by
        # NAS bearer procedures steer packets to the lcid's bearer; the
        # default bearer carries everything unmatched
        from .nas.tft import TftMatcher
        self.tft = TftMatcher(default_lcid=3)

    CRS_MUTE_REL_DB = 6.0  # mute a neighbor's CRS when within this of serving

    def _neighbor_crs_mute(self, pcis) -> torch.Tensor | None:
        """[nsym_sf, nof_re] float32 mask on the device, zeroing REs under
        the given neighbor cells' CRS (FeICIC-style CRS interference mitigation: a
        strong neighbor's CRS punctures our control/data REs with
        confidently-wrong LLRs; muting turns them into erasures, which the
        convolutional/turbo codes absorb).  Only neighbors measured within
        CRS_MUTE_REL_DB of the serving cell are muted — erasing REs under
        a WEAK neighbor throws away good signal (a real CRS-IC receiver
        gates on measured interference the same way)."""
        from .phy.chest.refsignal_dl import crs_mask

        if not pcis:
            return None
        mute = np.zeros_like(crs_mask(self.cell))
        for pci in pcis:
            mute |= crs_mask(Cell(n_prb=self.cell.n_prb, id=pci,
                                  nof_ports=self.cell.nof_ports))
        mute &= ~crs_mask(self.cell)  # never touch our own pilots
        return torch.as_tensor((~mute).astype(np.float32)).to(self.device)

    def _update_crs_mute(self):
        strong = frozenset(
            p for p, dbm in self._last_neighbors.items()
            if dbm >= self._serving_dbm - self.CRS_MUTE_REL_DB)
        if strong != self._muted_pcis:
            self._muted_pcis = strong
            self._crs_mute = self._neighbor_crs_mute(strong)

    def _reset_resel(self):
        """Zero the 36.304 Treselection state (entering/leaving camped —
        no hysteresis credit may carry across a connect/release cycle)."""
        self._resel_ms = 0
        self._resel_target = None

    def _switch_cell(self, pci: int):
        """Retune the PHY objects to a new serving cell; the RLC/PDCP
        bearers survive (36.331 handover / reestablishment keep AM state)."""
        self.cell = Cell(n_prb=self.cell.n_prb, id=pci,
                         nof_ports=self.cell.nof_ports)
        self.ue_dl = UeDl(self.cell)
        self.ue_ul = UeUl(self.cell)
        # keep the SIB2-derived PRACH geometry across the switch (intra-eNB
        # cells broadcast the same common config; re-receipt re-derives)
        if self.sib2 is not None:
            self.prach_cfg = self.sib2.prach_config(self.cell.ofdm)
        else:
            self.prach_cfg = PrachConfig(self.cell.ofdm, zero_corr_cfg=7)
        self._measurer = (IntraMeasure(self.cell.n_prb,
                                       tuple(sorted(self.known_pcis)))
                          if len(self.known_pcis) > 1 else None)
        self.rlm.reset()
        self._cell_switched = True
        self._muted_pcis = frozenset()
        self._crs_mute = None  # re-derived from fresh measurements

    # ---------------- TDD helpers ---------------------------------------
    def _ul_sf(self, tti: int) -> bool:
        from .phy.common.tdd import SfType

        return (self.tdd is not None
                and self.tdd.sf_type(tti % 10) is SfType.UL)

    def _next_ul(self, tti: int) -> int:
        return tti if self.tdd is None else self.tdd.next_ul(tti)

    def _sr_opportunity(self, tti: int) -> bool:
        if self.tdd is None:
            return tti % 5 == SR_SF
        return tti % 10 in self.tdd.sr_subframes()

    # ---------------- DL ----------------------------------------------------
    def rx_subframe(self, samples, tti: int):
        """samples: the DL subframe of `tti` (a tensor or host samples,
        taken to the app's device), or None in a TDD uplink subframe."""
        sf = tti % 10
        if self._ul_sf(tti):
            # uplink subframe: no DL signal to process, timers still run
            self.ra.tick()
            self.srb1.tick()
            self.drb1.tick()
            return
        samples = as_tensor(samples, self.device)
        if self.state == "mib" and sf == 0:
            ok, mib, phase, ports = _ue_mib(self.cell.id, self.cell.n_prb
                                            ).decode(samples)
            if ok:
                self.mib = mib
                self.state = "rach_wait"
        grid, ce, info = self.ue_dl.fft_estimate(samples, sf)
        if self._crs_mute is not None:
            grid = grid * self._crs_mute  # neighbor-CRS muting (CRS-IC)

        # -- mobility rails: T304 supervision, radio-link monitoring, and
        #    neighbor measurement (sync.cc:664-688, intra_measure.cc) ------
        if self.t304 >= 0:
            self.t304 -= 1
            if self.t304 < 0 and self._ho_fallback is not None:
                # T304 expiry = handover failure -> reestablish carrying the
                # SOURCE cell identity (36.331 5.3.5.6)
                pci, crnti = self._ho_fallback
                self._start_reestablishment(pci, crnti, cause="ho_fail")
                return
        if (self.state == "connected" and self.crnti
                and self.pdcp1 is not None):
            snr_db = 10.0 * np.log10(max(float(info["snr"]), 1e-12))
            if self.rlm.step(snr_db):
                self._start_reestablishment(self.cell.id, self.crnti,
                                            cause="other_fail")
                return
        if (self._measurer is not None
                and self.state in ("connected", "camped")
                and tti % MEAS_PERIOD_MS == 0):
            self._do_measure(samples, sf)

        pd = _pdcch(self.cell, CFI, sf)
        size = format0_1a_size(self.cell.n_prb)

        def decode_pdsch_for(dci, rnti):
            grant = dci.grant(self.cell.n_prb, rnti)
            pdsch = Pdsch(self.cell, grant, sf, cfi=CFI, rnti=rnti)
            bits, ok = pdsch.decode(grid, ce, info["noise"])
            if not bool(ok):
                return None
            return np.packbits(bits.cpu().numpy()).tobytes()

        # blind searches relevant to the current state (cc_worker.cc:383
        # scope: common space for SI/RA-RNTI, UE-specific + common for the
        # C-RNTI, formats 0/1A at one payload size and format 1 at another)
        # LTE gives at most ONE DL assignment and ONE UL grant per RNTI per
        # TTI; nested candidates can re-detect the same payload at a larger
        # aggregation level (zero-padded CCEs decode as erasures), so stop
        # at the first successful decode — ue_dl.c's duplicate filtering.
        common_rntis = []
        if self.state in ("rach_wait", "rach_sent", "ho_rach_sent"):
            common_rntis.append(RA_RNTI)
        if self.state == "camped":
            # RRC_IDLE camped: monitor the paging occasion on P-RNTI
            # (36.304 §7; the reference pages every PO of the UE's PF)
            common_rntis.append(P_RNTI)
        common_rntis.append(SI_RNTI)
        for rnti in common_rntis:
            got = False
            for loc, payload in pd.search_all(grid, ce, rnti, size, Ls=(4, 8)):
                dci1a = unpack_format1a(payload, self.cell.n_prb)
                if dci1a is not None:
                    raw = decode_pdsch_for(dci1a, rnti)
                    if raw is not None:
                        self._handle_dlsch(rnti, raw, tti)
                        got = True
                        break
            if not got:
                # common search space covers {1A, 1C} (ue_dl.c:43); 1C is
                # the compact broadcast format some networks use for SI/RAR
                for loc, payload in pd.search_all(
                        grid, ce, rnti, format1c_size(self.cell.n_prb),
                        Ls=(4, 8)):
                    dci1c = unpack_format1c(payload, self.cell.n_prb)
                    if dci1c is not None:
                        raw = decode_pdsch_for(dci1c, rnti)
                        if raw is not None:
                            self._handle_dlsch(rnti, raw, tti)
                            break
        if self.crnti and not self._cell_switched:
            got_dl = got_ul = False
            for loc, payload in pd.search(grid, ce, self.crnti, size):
                if self._cell_switched:
                    break  # HO executed mid-drain: this grid is stale
                dci1a = unpack_format1a(payload, self.cell.n_prb)
                if dci1a is not None and not got_dl:
                    raw = decode_pdsch_for(dci1a, self.crnti)
                    if raw is None:
                        self._arm_ack(tti, loc.cce, 0)  # NACK
                        continue
                    self._arm_ack(tti, loc.cce, 1)
                    self._handle_dlsch(self.crnti, raw, tti)
                    got_dl = True
                elif dci1a is None and not got_ul:
                    dci0 = unpack_format0(payload, self.cell.n_prb)
                    if dci0 is not None:
                        k = 4 if self.tdd is None else self.tdd.k_pusch(sf)
                        if k:
                            self._queue_ul(tti + k,
                                           UlGrant(dci0.rb_start,
                                                   dci0.l_crb, dci0.mcs_rv))
                        got_ul = True
                if got_dl and got_ul:
                    break
            # DCI format 1 (RBG type-0 assignments from the eNB scheduler)
            # lives at a distinct payload size in the UE-specific space
            if not got_dl and not self._cell_switched:
                for loc, payload in pd.search(grid, ce, self.crnti,
                                              format1_size(self.cell.n_prb),
                                              include_common=False):
                    dci1 = unpack_format1(payload, self.cell.n_prb)
                    if dci1 is not None:
                        raw = decode_pdsch_for(dci1, self.crnti)
                        if raw is None:
                            self._arm_ack(tti, loc.cce, 0)  # NACK
                            continue
                        self._arm_ack(tti, loc.cce, 1)
                        self._handle_dlsch(self.crnti, raw, tti)
                        break
        self._cell_switched = False
        self.ra.tick()
        self.srb1.tick()
        self.drb1.tick()
        if self.state == "rach_wait" and sf == 0 and self.sib2 is not None:
            # schedule PRACH for the next PRACH opportunity — FDD: the
            # subframe the broadcast prach-ConfigIndex names (36.211 table
            # 5.7.1-2); TDD: the first UL subframe — only once SIB2 has
            # delivered the PRACH config (36.331: SI acquisition precedes RA)
            p = self.ra.start(np.random.default_rng(self.cell.id + tti))
            if self.tdd is None:
                psf = self.sib2.prach_sf
                tp = tti + ((psf - tti) % 10 or 10)
            else:
                tp = self._next_ul(tti + 1)
            self.pending_ul[tp] = UlTx(tp, "prach", preamble=p)
            self.state = "rach_sent"
        elif self.state == "ho_rach" and sf == 0:
            # contention-free RACH on the target cell (36.321 5.1.2);
            # intra-eNB target shares the source's SIB2 PRACH timing
            p = self.ra.start_dedicated(self._ded_preamble)
            if self.tdd is None and self.sib2 is not None:
                psf = self.sib2.prach_sf
                tp = tti + ((psf - tti) % 10 or 10)
            else:
                tp = self._next_ul(tti + 1)
            self.pending_ul[tp] = UlTx(tp, "prach", preamble=p)
            self.state = "ho_rach_sent"

    def _arm_ack(self, tti: int, ncce: int, bit: int):
        """Queue HARQ feedback for the DL assignment decoded at `tti`
        (FDD: tti+4; TDD: the next UL subframe from there).  A later
        candidate succeeding upgrades NACK to ACK, never the reverse."""
        key = self._next_ul(tti + 4)
        cur = self.pending_ack.get(key)
        if cur is None or (cur[1] == 0 and bit == 1):
            self.pending_ack[key] = (ncce, bit)

    # ---------------- UL ----------------------------------------------------
    def tx_subframe(self, tti: int):
        """Returns UL samples for this TTI (a tensor on the device) or None."""
        if self.tdd is not None and not self._ul_sf(tti):
            return None
        tx = self.pending_ul.pop(tti, None)
        ack = self.pending_ack.pop(tti, None)
        if tx is None:
            sr_wanted = (self._sr_opportunity(tti) and self.crnti
                         and not self.pending_ul
                         and self.state == "connected"
                         and (self.srb1.get_buffer_state() > 0
                              or self.drb1.get_buffer_state() > 0))
            if ack is not None and self.crnti and self.state == "connected":
                # HARQ-ACK on PUCCH 1a; a simultaneous positive SR moves it
                # onto the SR resource (36.213 §10.1, pucch_proc)
                uci = UciUsage(acks=(AckCfg(nof_acks=1, ncce=(ack[0],)),),
                               sr_positive=bool(sr_wanted))
                cfg = PucchProcCfg(n_pucch_sr=self.crnti % 12,
                                   n_pucch_1=self.n_pucch_1)
                fmt = select_format(self.cell, cfg, uci)
                n_pucch, b = get_npucch(self.cell, cfg, uci, (ack[1],))
                pucch = Pucch(self.cell,
                              PucchConfig(fmt, n_pucch=n_pucch),
                              sf_idx=tti % 10)
                return self.ue_ul.encode_pucch(pucch, ack_bits=b,
                                               device=self.device)
            # SR: connected, data waiting, but no grant anywhere in flight
            if sr_wanted:
                pucch = Pucch(self.cell,
                              PucchConfig("1", n_pucch=self.crnti % 12),
                              sf_idx=tti % 10)
                return self.ue_ul.encode_pucch(pucch, device=self.device)
            return None
        if tx.kind == "prach":
            # the waveform is built on the host and moved to the device once
            s = prach_gen(self.prach_cfg, tx.preamble)
            out = np.zeros(self.cell.ofdm.sf_len, np.complex64)
            out[: len(s)] = s
            return torch.as_tensor(out).to(self.device)
        # PUSCH: fill the TBS from RLC buffers; a pending HARQ-ACK rides
        # the PUSCH as multiplexed UCI (36.212 §5.2.2.6)
        with_uci = ack is not None and self.state == "connected"
        pusch = Pusch(self.cell, tx.grant, tti % 10, rnti=self.crnti,
                      uci=UciCfgUl(o_ack=1) if with_uci else None)
        tbs_bytes = tx.grant.tbs // 8
        payload = tx.payload or self._build_ul_mac(tbs_bytes)
        raw = payload + bytes(tbs_bytes - len(payload))
        bits = np.unpackbits(np.frombuffer(raw, np.uint8))[: tx.grant.tbs]
        bits = torch.as_tensor(bits).to(self.device)
        if with_uci:
            return self.ue_ul.encode_pusch(
                pusch, bits, ack=torch.tensor([ack[1]], dtype=torch.uint8,
                                              device=self.device))
        return self.ue_ul.encode_pusch(pusch, bits)

    def _queue_ul(self, tti: int, grant: UlGrant):
        self.pending_ul[tti] = UlTx(tti, "pusch", grant)

    def _build_ul_mac(self, tbs_bytes: int) -> bytes:
        """Mux the UL-SCH PDU: drain each bearer while the grant has room
        (mux::pdu_get semantics — a pending RLC STATUS PDU must not displace
        the queued SDUs when both fit)."""
        pdu = MacPdu(ul=True)
        room = tbs_bytes - 6  # BSR CE + its subheader + final padding marker
        for lcid, rlc in ((1, self.srb1), (3, self.drb1)):
            while rlc.get_buffer_state() > 0 and room > 6:
                sdu = rlc.read_pdu(room - 3)
                if not sdu:
                    break
                pdu.add_sdu(lcid, sdu)
                room -= len(sdu) + 3
        # short BSR CE: remaining demand so SchedUl keeps (or stops) granting
        remaining = self.srb1.get_buffer_state() + self.drb1.get_buffer_state()
        pdu.add_ce(int(UL_LCID.SHORT_BSR), short_bsr_ce(0, remaining))
        # explicit padding subheader: the parser must not swallow TBS padding
        return pdu.pack(pdu_len=tbs_bytes)

    # ---------------- stack --------------------------------------------------
    def _handle_dlsch(self, rnti: int, raw: bytes, tti: int):
        if rnti == P_RNTI:
            msg = rrc_unpack(raw, "pcch")
            if isinstance(msg, Paging) and self.nas.guti in msg.records:
                self.paged += 1
                if self.state == "camped":
                    # paging response: bring the connection back up
                    # (reference: NAS service request through a new RRC
                    # connection; here the NAS re-attaches over the new
                    # connection)
                    self._ra_mode = "attach"
                    self._reset_resel()
                    self.state = "rach_wait"
            return
        if rnti == SI_RNTI:
            msg = rrc_unpack(raw, "bcch")
            if isinstance(msg, Sib1):
                self.sib1 = msg
            elif isinstance(msg, Sib2):
                # derive live config from the broadcast (NOT from shared
                # constants): PRACH cyclic-shift geometry + ACK region.
                # Unconditional: a cell switch may have reset prach_cfg
                # (PrachConfig construction is cached, so this is free)
                self.prach_cfg = msg.prach_config(self.cell.ofdm)
                self.n_pucch_1 = msg.n1_pucch_an
                self.sib2 = msg
            return
        if rnti == RA_RNTI:
            if self.ra.state != "wait_rar":
                return
            if self._ded_preamble >= 0:
                got = self.ra.rx_rar_dedicated(raw)
                if got is not None:
                    # contention-free handover RACH done; msg3 carries the
                    # ReconfigurationComplete already queued on SRB1
                    self.crnti = got[0]
                    self._ded_preamble = -1
                    self.t304 = -1
                    self._ho_fallback = None
                    self.state = "connected"
                    self.ho_count += 1
                    t3 = self._next_ul(tti + 4)
                    self.pending_ul[t3] = UlTx(t3, "pusch", MSG3_GRANT)
                return
            if self._ra_mode == "reest":
                self._ccch_sdu = self._reest_req
            else:
                self._ccch_sdu = rrc_pack(ConnectionRequest(
                    ue_identity=bytes([self.cell.id & 0xFF])
                    + (self.identity if self.identity is not None else
                       np.random.default_rng(id(self) & 0xFFFF).integers(
                           0, 256, 4).astype(np.uint8).tobytes())))
            msg3 = self.ra.rx_rar(raw, ccch_sdu=self._ccch_sdu)
            if msg3 is not None:
                self.crnti = self.ra.temp_crnti
                # msg3 goes on the RAR-granted PUSCH 4 TTIs after the RAR
                # (TDD: the first UL subframe from there)
                t3 = self._next_ul(tti + 4)
                self.pending_ul[t3] = UlTx(t3, "pusch", MSG3_GRANT,
                                           payload=msg3.pack())
            return
        # C-RNTI MAC PDU
        pdu = MacPdu.parse(raw)
        for s in pdu.subpdus:
            if s.lcid == int(DL_LCID.CON_RES_ID):
                if self.ra.rx_msg4(MacPdu(subpdus=[s]).pack()):
                    self.state = "connected"
            elif s.lcid == 0:
                self._handle_rrc(rrc_unpack(s.payload, "dl_ccch"))
            elif s.lcid == 1:
                self.srb1.write_pdu(s.payload)
            elif s.lcid == 3:
                self.drb1.write_pdu(s.payload)
        for sdu in self.srb1.rx_sdus[:]:
            self.srb1.rx_sdus.remove(sdu)
            if self.pdcp1 is not None:
                sdu = self.pdcp1.rx(sdu)
                if sdu is None:
                    continue
            self._handle_rrc(rrc_unpack(sdu, "dl_dcch"))
        for sdu in self.drb1.rx_sdus[:]:
            self.drb1.rx_sdus.remove(sdu)
            if self.pdcp_drb is not None:
                pkt = self.pdcp_drb.rx(sdu)
                if pkt is not None:
                    self.rx_data.append(pkt)

    def _handle_rrc(self, msg):
        if isinstance(msg, ConnectionSetup):
            self.rrc_state = "connected"
            nas0 = self.nas.start_attach()
            self.srb1.write_sdu(rrc_pack(ConnectionSetupComplete(nas_pdu=nas0)))
        elif isinstance(msg, DlInformationTransfer):
            for ul in self.nas.rx_nas(msg.nas_pdu):
                self.srb1.write_sdu(rrc_pack(UlInformationTransfer(nas_pdu=ul)))
        elif isinstance(msg, RrcSecurityModeCommand):
            self.srb1.write_sdu(rrc_pack(RrcSecurityModeComplete()))
            kenb = kdf_kenb(self.nas.kasme, 0)
            k_up, k_rrc_int = kdf_as_keys(kenb, EEA2, EIA2)
            self.pdcp1 = PdcpEntity(PdcpConfig(is_srb=True, bearer_id=1,
                                               ea=EEA2, ia=EIA2),
                                    kenb[:16], k_rrc_int, is_ue=True)
            self.pdcp_drb = PdcpEntity(PdcpConfig(is_srb=False, bearer_id=1,
                                                  ea=EEA2), k_up, is_ue=True)
        elif isinstance(msg, ConnectionReconfiguration):
            if msg.mobility is not None:
                self._exec_handover(msg.mobility)
                return
            # nas_pdu is empty for pure-reconfiguration (e.g. the DRB re-add
            # after reestablishment, 36.331 5.3.7.5)
            for ul in (self.nas.rx_nas(msg.nas_pdu) if msg.nas_pdu else ()):
                self.srb1.write_sdu(self.pdcp1.tx(
                    rrc_pack(UlInformationTransfer(nas_pdu=ul))))
            self.srb1.write_sdu(self.pdcp1.tx(
                rrc_pack(ConnectionReconfigurationComplete())))
            self.rrc_state = "reconfigured"
            if msg.meas is not None:
                self.meas_engine = MeasEventEngine(1, ReportConfig(
                    event="a3", a3_offset_db=msg.meas.a3_offset_db,
                    hysteresis_db=msg.meas.hysteresis_db,
                    time_to_trigger_ms=msg.meas.time_to_trigger_ms))
        elif isinstance(msg, Reestablishment):
            # SRB1 resumes with PDCP continuity; complete over PDCP, the eNB
            # re-adds the DRB afterwards (36.331 5.3.7.5)
            self.rrc_state = "connected"
            self.reest_count += 1
            self._ra_mode = "attach"
            self.srb1.write_sdu(self.pdcp1.tx(rrc_pack(
                ReestablishmentComplete())))
        elif isinstance(msg, ConnectionRelease):
            # 36.331 5.3.8: leave RRC_CONNECTED, camp and monitor paging;
            # bearers and AS security die with the connection
            self.rrc_state = "idle"
            self.state = "camped"
            self._reset_resel()  # Treselection starts fresh in idle
            self.crnti = 0
            self.pending_ul.clear()
            self.srb0, self.srb1, self.drb1 = RlcTm(), RlcAm(), RlcAm()
            self.pdcp1 = None
            self.pdcp_drb = None
            self._ra_mode = "attach"
        elif isinstance(msg, ReestablishmentReject):
            self.rrc_state = "idle"
            self.crnti = 0
            self._ra_mode = "attach"

    # ---------------- mobility -------------------------------------------
    def _do_measure(self, samples, sf: int):
        """One IntraMeasure dispatch covering serving + all neighbor PCIs;
        feed the A3 engine and emit MeasurementReports (rrc_meas.cc)."""
        m = self._measurer.measure(samples, sf)
        pcis = self._measurer.pcis
        lin = m["rsrp"].cpu().numpy().astype(np.float64).reshape(len(pcis))
        dbm = RSRP_REF_DBM + 10.0 * np.log10(np.maximum(lin, 1e-15))
        by_pci = dict(zip(pcis, dbm.tolist()))
        serving = by_pci.pop(self.cell.id, None)
        self._last_neighbors = by_pci
        if serving is None:
            return
        self._serving_dbm = float(serving)
        self._update_crs_mute()
        if self.state == "camped" and by_pci:
            # 36.304 R-criterion cell reselection: a neighbor out-ranking
            # the serving cell by Qhyst for Treselection moves the camp
            # (rrc_cell.cc / cell selection procedures analog)
            best = max(by_pci, key=by_pci.get)
            if by_pci[best] > serving + QHYST_DB:
                # Treselection is per candidate: a change of best cell
                # restarts the timer (no credit carries between neighbors)
                if best != self._resel_target:
                    self._resel_target = best
                    self._resel_ms = 0
                self._resel_ms += MEAS_PERIOD_MS
                if self._resel_ms >= T_RESEL_MS:
                    self.known_pcis.add(best)
                    self._switch_cell(best)
                    self.reselect_count += 1
                    self._resel_ms = 0
                    self._resel_target = None
            else:
                self._resel_ms = 0
                self._resel_target = None
            return
        if self.meas_engine is None or self.pdcp1 is None:
            return
        rep = self.meas_engine.tick(float(serving), by_pci, MEAS_PERIOD_MS)
        if rep is not None:
            self.srb1.write_sdu(self.pdcp1.tx(rrc_pack(MeasurementReportMsg(
                meas_id=rep.meas_id, serving_rsrp_dbm=float(serving),
                neighbors=rep.triggered))))

    def _exec_handover(self, mci):
        """36.331 5.3.5.4: apply mobilityControlInfo — the complete goes to
        the TARGET cell in msg3 after the dedicated-preamble RACH (T304)."""
        self.srb1.write_sdu(self.pdcp1.tx(rrc_pack(
            ConnectionReconfigurationComplete())))
        self._ho_fallback = (self.cell.id, self.crnti)
        self.known_pcis.add(mci.target_pci)
        self._switch_cell(mci.target_pci)
        self.crnti = 0
        self.pending_ul.clear()
        self._ded_preamble = mci.ra_preamble
        self.t304 = mci.t304_ms
        self.state = "ho_rach"

    def _start_reestablishment(self, pci: int, crnti: int, cause: str):
        """RLF / HO failure -> cell selection + reestablishment RACH with
        (C-RNTI, PCI, ShortMAC-I) (36.331 5.3.7, sync.cc RLF path)."""
        if self.pdcp1 is None or not crnti:
            self.rrc_state = "idle"  # no AS security yet: go to idle
            self.state = "mib"
            return
        smi = short_mac_i(self.pdcp1.k_int, self.pdcp1.cfg.ia,
                          Sib1().cell_id, pci, crnti)
        self._reest_req = rrc_pack(ReestablishmentRequest(
            c_rnti=crnti, pci=pci, short_mac_i=smi, cause=cause))
        self._ra_mode = "reest"
        # cell selection: strongest recently-measured neighbor, else stay
        cands = dict(self._last_neighbors)
        target = max(cands, key=cands.get) if cands else self.cell.id
        self._switch_cell(target)
        self.crnti = 0
        self.pending_ul.clear()
        self.ra = UeRaProc()
        self._ded_preamble = -1
        self.t304 = -1
        self._ho_fallback = None
        self.state = "rach_wait"

    def send_data(self, packet: bytes):
        """Queue an UL user-plane packet: the TFT matcher picks the
        bearer (gw.cc:343 check_tft_filter_match); unmatched traffic and
        unknown LCIDs ride the default DRB."""
        lcid = self.tft.check_match(packet)
        rlc, pdcp = self.bearers.get(lcid, (self.drb1, self.pdcp_drb))
        rlc.write_sdu(pdcp.tx(packet))

    @property
    def bearers(self) -> dict:
        """lcid -> (rlc, pdcp) user-plane bearers (default DRB on 3)."""
        return {3: (self.drb1, self.pdcp_drb)}
