"""RRC message API — dataclass views over real 36.331 UNALIGNED PER.

Reference behavior: srsue/srsenb RRC procedures exchange the generated
ASN.1 classes (lib/src/asn1/rrc/*); here the stack passes compact
dataclasses and `rrc_pack`/`rrc_unpack` convert them to/from the actual
36.331 PER wire format (schemas in asn1_rrc.py, byte-exact against the
reference's test vectors per tests/test_asn1_per.py).  The wire is
therefore interoperable with any 36.331 peer; the dataclasses carry only
the fields the procedures consume, with spec defaults for the rest.

Each message type lives on exactly one logical channel, so packing needs
no channel hint; unpacking takes the channel the transport delivered on
(SRB0 UL -> "ul_ccch", SRB1 DL -> "dl_dcch", BCCH, PCCH, ...), exactly as
the reference selects a codec per channel (srsue/src/stack/rrc/rrc.cc
parse_dl_ccch/parse_dl_dcch).
"""

from __future__ import annotations

from dataclasses import dataclass

from . import asn1_rrc as S
from .per import BitReader

EST_CAUSES = ("emergency", "high_prio_access", "mt_access", "mo_sig",
              "mo_data", "delay_tolerant_access_v1020", "mo_voice_call_v1280",
              "spare1")
REL_CAUSES = ("load_balancing_ta_urequired", "other",
              "cs_fallback_high_prio_v1020", "rrc_suspend_v1320")
EA_NAMES = ("eea0", "eea1", "eea2", "eea3_v1130")
IA_NAMES = ("eia0_v920", "eia1", "eia2", "eia3_v1130")
SI_PERIOD = {8: "rf8", 16: "rf16", 32: "rf32", 64: "rf64", 128: "rf128",
             256: "rf256", 512: "rf512"}


def _plmn_to_tree(plmn: bytes) -> dict:
    """3-byte BCD PLMN (24.301 9.9.3.32 order) -> mcc/mnc digit lists."""
    d = [plmn[0] & 0xF, plmn[0] >> 4, plmn[1] & 0xF,
         plmn[2] & 0xF, plmn[2] >> 4, plmn[1] >> 4]
    mnc = d[3:5] if d[5] == 0xF else d[3:6]
    return {"mcc": d[:3], "mnc": mnc}


def _plmn_from_tree(t: dict) -> bytes:
    mcc = t.get("mcc", [0, 0, 0])
    mnc = list(t["mnc"])
    d6 = 0xF if len(mnc) == 2 else mnc[2]
    return bytes([(mcc[1] << 4) | mcc[0], (d6 << 4) | mcc[2],
                  (mnc[1] << 4) | mnc[0]])


@dataclass
class ConnectionRequest:
    ue_identity: bytes  # 40-bit random value
    cause: int = 4  # index into EST_CAUSES (mo-Data)

    _channel = "ul_ccch"

    def to_tree(self):
        return ("rrc_conn_request", {"crit_exts": (
            "rrc_conn_request_r8",
            {"ue_id": ("random_value",
                       int.from_bytes(self.ue_identity[:5], "big")),
             "establishment_cause": EST_CAUSES[self.cause],
             "spare": 0})})

    @staticmethod
    def from_tree(t):
        r8 = t["crit_exts"][1]
        return ConnectionRequest(
            ue_identity=r8["ue_id"][1].to_bytes(5, "big"),
            cause=EST_CAUSES.index(r8["establishment_cause"]))


@dataclass
class ConnectionSetup:
    srb1_config: int = 1  # 1 = default SRB1 configuration (36.331 9.2.1)

    _channel = "dl_ccch"

    def to_tree(self):
        rr = {"srb_to_add_mod_list": [{"srb_id": 1}]}
        return ("rrc_conn_setup", {
            "rrc_transaction_id": 0,
            "crit_exts": ("c1", ("rrc_conn_setup_r8", {"rr_cfg_ded": rr}))})

    @staticmethod
    def from_tree(t):
        rr = t["crit_exts"][1][1]["rr_cfg_ded"]
        srbs = rr.get("srb_to_add_mod_list", [])
        return ConnectionSetup(srb1_config=srbs[0]["srb_id"] if srbs else 0)


@dataclass
class ConnectionSetupComplete:
    nas_pdu: bytes = b""

    _channel = "ul_dcch"

    def to_tree(self):
        return ("rrc_conn_setup_complete", {
            "rrc_transaction_id": 0,
            "crit_exts": ("c1", ("rrc_conn_setup_complete_r8",
                                 {"sel_plmn_id": 1,
                                  "ded_info_nas": self.nas_pdu}))})

    @staticmethod
    def from_tree(t):
        return ConnectionSetupComplete(
            nas_pdu=t["crit_exts"][1][1]["ded_info_nas"])


@dataclass
class DlInformationTransfer:
    nas_pdu: bytes

    _channel = "dl_dcch"

    def to_tree(self):
        return ("dl_info_transfer", {
            "rrc_transaction_id": 0,
            "crit_exts": ("c1", ("dl_info_transfer_r8",
                                 {"ded_info_type":
                                  ("ded_info_nas", self.nas_pdu)}))})

    @staticmethod
    def from_tree(t):
        return DlInformationTransfer(
            nas_pdu=t["crit_exts"][1][1]["ded_info_type"][1])


@dataclass
class UlInformationTransfer:
    nas_pdu: bytes

    _channel = "ul_dcch"

    def to_tree(self):
        return ("ul_info_transfer", {"crit_exts": ("c1", (
            "ul_info_transfer_r8",
            {"ded_info_type": ("ded_info_nas", self.nas_pdu)}))})

    @staticmethod
    def from_tree(t):
        return UlInformationTransfer(
            nas_pdu=t["crit_exts"][1][1]["ded_info_type"][1])


@dataclass
class RrcSecurityModeCommand:
    ea: int
    ia: int

    _channel = "dl_dcch"

    def to_tree(self):
        return ("security_mode_cmd", {
            "rrc_transaction_id": 0,
            "crit_exts": ("c1", ("security_mode_cmd_r8", {
                "security_cfg_smc": {"security_algorithm_cfg": {
                    "ciphering_algorithm": EA_NAMES[self.ea],
                    "integrity_prot_algorithm": IA_NAMES[self.ia]}}}))})

    @staticmethod
    def from_tree(t):
        alg = t["crit_exts"][1][1]["security_cfg_smc"][
            "security_algorithm_cfg"]
        return RrcSecurityModeCommand(
            ea=EA_NAMES.index(alg["ciphering_algorithm"]),
            ia=IA_NAMES.index(alg["integrity_prot_algorithm"]))


@dataclass
class RrcSecurityModeComplete:
    _channel = "ul_dcch"

    def to_tree(self):
        return ("security_mode_complete", {
            "rrc_transaction_id": 0,
            "crit_exts": ("security_mode_complete_r8", {})})

    @staticmethod
    def from_tree(t):
        return RrcSecurityModeComplete()


@dataclass
class MobilityControl:
    """mobilityControlInfo fields the handover procedure consumes."""

    target_pci: int
    new_crnti: int
    t304_ms: int = 100
    ra_preamble: int = -1  # dedicated (contention-free) preamble; -1 = CBRA

    _T304 = {50: "ms50", 100: "ms100", 150: "ms150", 200: "ms200",
             500: "ms500", 1000: "ms1000", 2000: "ms2000"}

    def to_tree(self):
        t = {"target_pci": self.target_pci,
             "t304": self._T304[self.t304_ms],
             "new_ue_id": self.new_crnti,
             # common config of the target cell: spec defaults (the full
             # values normally mirror the target's SIB2)
             "rr_cfg_common": {
                 "prach_cfg": {"root_seq_idx": 0},
                 "pusch_cfg_common": {
                     "pusch_cfg_basic": {
                         "n_sb": 1, "hop_mode": "inter_sub_frame",
                         "pusch_hop_offset": 0, "enable64_qam": False},
                     "ul_ref_sigs_pusch": {
                         "group_hop_enabled": False,
                         "group_assign_pusch": 0,
                         "seq_hop_enabled": False, "cyclic_shift": 0}},
                 "ul_cp_len": "len1"}}
        if self.ra_preamble >= 0:
            t["rach_cfg_ded"] = {"ra_preamb_idx": self.ra_preamble,
                                 "ra_prach_mask_idx": 0}
        return t

    @staticmethod
    def from_tree(t):
        ded = t.get("rach_cfg_ded")
        return MobilityControl(
            target_pci=t["target_pci"], new_crnti=t["new_ue_id"],
            t304_ms=int(t["t304"][2:]),
            ra_preamble=ded["ra_preamb_idx"] if ded else -1)


@dataclass
class MeasConfigA3:
    """measConfig subset: one EUTRA object + one A3 event report config."""

    a3_offset_db: float = 3.0
    hysteresis_db: float = 0.0
    time_to_trigger_ms: int = 0
    earfcn: int = 3400

    _TTT = {0: "ms0", 40: "ms40", 64: "ms64", 80: "ms80", 100: "ms100",
            128: "ms128", 160: "ms160", 256: "ms256", 320: "ms320",
            480: "ms480", 512: "ms512", 640: "ms640"}

    def to_tree(self):
        return {
            "meas_obj_to_add_mod_list": [
                {"meas_obj_id": 1,
                 "meas_obj": ("meas_obj_eutra",
                              {"carrier_freq": self.earfcn,
                               "allowed_meas_bw": "mbw6",
                               "presence_ant_port1": False,
                               "neigh_cell_cfg": 0})}],
            "report_cfg_to_add_mod_list": [
                {"report_cfg_id": 1,
                 "report_cfg": ("report_cfg_eutra", {
                     "trigger_type": ("event", {
                         "event_id": ("event_a3", {
                             # a3-Offset signalled in 0.5 dB units
                             "a3_offset": int(round(2 * self.a3_offset_db)),
                             "report_on_leave": False}),
                         "hysteresis": int(round(2 * self.hysteresis_db)),
                         "time_to_trigger":
                             self._TTT[self.time_to_trigger_ms]}),
                     "trigger_quant": "rsrp",
                     "report_quant": "both",
                     "max_report_cells": 8,
                     "report_interv": "ms120",
                     "report_amount": "r1"})}],
            "meas_id_to_add_mod_list": [
                {"meas_id": 1, "meas_obj_id": 1, "report_cfg_id": 1}]}

    @staticmethod
    def from_tree(t):
        rep = t["report_cfg_to_add_mod_list"][0]["report_cfg"][1]
        ev = rep["trigger_type"][1]
        obj = t["meas_obj_to_add_mod_list"][0]["meas_obj"][1]
        return MeasConfigA3(
            a3_offset_db=ev["event_id"][1]["a3_offset"] / 2.0,
            hysteresis_db=ev["hysteresis"] / 2.0,
            time_to_trigger_ms=int(ev["time_to_trigger"][2:]),
            earfcn=obj["carrier_freq"])


@dataclass
class ConnectionReconfiguration:
    drb_id: int = 1
    nas_pdu: bytes = b""
    mobility: MobilityControl | None = None
    meas: MeasConfigA3 | None = None

    _channel = "dl_dcch"

    def to_tree(self):
        r8 = {}
        if self.drb_id:
            r8["rr_cfg_ded"] = {"drb_to_add_mod_list": [
                {"eps_bearer_id": 5, "drb_id": self.drb_id, "lc_ch_id": 3}]}
        if self.nas_pdu:
            r8["ded_info_nas_list"] = [self.nas_pdu]
        if self.mobility is not None:
            r8["mob_ctrl_info"] = self.mobility.to_tree()
        if self.meas is not None:
            r8["meas_cfg"] = self.meas.to_tree()
        return ("rrc_conn_recfg", {
            "rrc_transaction_id": 0,
            "crit_exts": ("c1", ("rrc_conn_recfg_r8", r8))})

    @staticmethod
    def from_tree(t):
        r8 = t["crit_exts"][1][1]
        nas = r8.get("ded_info_nas_list", [b""])
        drbs = r8.get("rr_cfg_ded", {}).get("drb_to_add_mod_list", [])
        mci = r8.get("mob_ctrl_info")
        mc = r8.get("meas_cfg")
        return ConnectionReconfiguration(
            drb_id=drbs[0]["drb_id"] if drbs else 0, nas_pdu=nas[0],
            mobility=MobilityControl.from_tree(mci) if mci else None,
            meas=MeasConfigA3.from_tree(mc) if mc else None)


@dataclass
class ConnectionReconfigurationComplete:
    _channel = "ul_dcch"

    def to_tree(self):
        return ("rrc_conn_recfg_complete", {
            "rrc_transaction_id": 0,
            "crit_exts": ("rrc_conn_recfg_complete_r8", {})})

    @staticmethod
    def from_tree(t):
        return ConnectionReconfigurationComplete()


@dataclass
class MeasurementReportMsg:
    """MeasurementReport: serving + triggered neighbor RSRPs.

    RSRP values carried in the 36.133 9.1.4 report range 0..97
    (value = dBm + 141, clipped); the dataclass keeps dBm floats.
    """

    meas_id: int = 1
    serving_rsrp_dbm: float = -100.0
    neighbors: dict = None  # pci -> rsrp dBm

    _channel = "ul_dcch"

    @staticmethod
    def _q(dbm: float) -> int:
        return max(0, min(97, int(round(dbm + 141))))

    @staticmethod
    def _dq(v: int) -> float:
        return float(v - 141)

    def to_tree(self):
        res = {"meas_id": self.meas_id,
               "meas_result_pcell": {
                   "rsrp_result": self._q(self.serving_rsrp_dbm),
                   "rsrq_result": 0}}
        if self.neighbors:
            res["meas_result_neigh_cells"] = ("meas_result_list_eutra", [
                {"pci": pci,
                 "meas_result": {"rsrp_result": self._q(dbm)}}
                for pci, dbm in sorted(self.neighbors.items())])
        return ("meas_report", {"crit_exts": ("c1", (
            "meas_report_r8", {"meas_results": res}))})

    @staticmethod
    def from_tree(t):
        res = t["crit_exts"][1][1]["meas_results"]
        neigh = {}
        nc = res.get("meas_result_neigh_cells")
        if nc and nc[0] == "meas_result_list_eutra":
            for e in nc[1]:
                neigh[e["pci"]] = MeasurementReportMsg._dq(
                    e["meas_result"]["rsrp_result"])
        return MeasurementReportMsg(
            meas_id=res["meas_id"],
            serving_rsrp_dbm=MeasurementReportMsg._dq(
                res["meas_result_pcell"]["rsrp_result"]),
            neighbors=neigh)


@dataclass
class ReestablishmentRequest:
    """RRCConnectionReestablishmentRequest (UL-CCCH, 36.331 5.3.7)."""

    c_rnti: int
    pci: int
    short_mac_i: int
    cause: str = "other_fail"  # recfg_fail | ho_fail | other_fail

    _channel = "ul_ccch"

    def to_tree(self):
        return ("rrc_conn_reest_request", {"crit_exts": (
            "rrc_conn_reest_request_r8",
            {"ue_id": {"c_rnti": self.c_rnti, "pci": self.pci,
                       "short_mac_i": self.short_mac_i},
             "reest_cause": self.cause, "spare": 0})})

    @staticmethod
    def from_tree(t):
        r8 = t["crit_exts"][1]
        uid = r8["ue_id"]
        return ReestablishmentRequest(
            c_rnti=uid["c_rnti"], pci=uid["pci"],
            short_mac_i=uid["short_mac_i"], cause=r8["reest_cause"])


@dataclass
class Reestablishment:
    """RRCConnectionReestablishment (DL-CCCH): re-establishes SRB1."""

    next_hop_chaining_count: int = 0

    _channel = "dl_ccch"

    def to_tree(self):
        return ("rrc_conn_reest", {
            "rrc_transaction_id": 0,
            "crit_exts": ("c1", ("rrc_conn_reest_r8", {
                "rr_cfg_ded": {"srb_to_add_mod_list": [{"srb_id": 1}]},
                "next_hop_chaining_count": self.next_hop_chaining_count}))})

    @staticmethod
    def from_tree(t):
        r8 = t["crit_exts"][1][1]
        return Reestablishment(
            next_hop_chaining_count=r8["next_hop_chaining_count"])


@dataclass
class ReestablishmentReject:
    _channel = "dl_ccch"

    def to_tree(self):
        return ("rrc_conn_reest_reject",
                {"crit_exts": ("rrc_conn_reest_reject_r8", {})})

    @staticmethod
    def from_tree(t):
        return ReestablishmentReject()


@dataclass
class ReestablishmentComplete:
    _channel = "ul_dcch"

    def to_tree(self):
        return ("rrc_conn_reest_complete", {
            "rrc_transaction_id": 0,
            "crit_exts": ("rrc_conn_reest_complete_r8", {})})

    @staticmethod
    def from_tree(t):
        return ReestablishmentComplete()


@dataclass
class Sib1:
    """SystemInformationBlockType1 (the fields the stack consumes)."""

    plmn: bytes = bytes.fromhex("00f110")
    tac: int = 1
    cell_id: int = 0x0019B01
    si_periodicity: int = 8

    _channel = "bcch"

    def to_tree(self):
        return ("sib_type1", {
            "cell_access_related_info": {
                "plmn_id_list": [{"plmn_id": _plmn_to_tree(self.plmn),
                                  "cell_reserved_for_oper": "not_reserved"}],
                "tac": self.tac,
                "cell_id": self.cell_id,
                "cell_barred": "not_barred",
                "intra_freq_resel": "allowed",
                "csg_ind": False},
            "cell_sel_info": {"q_rx_lev_min": -70},
            "freq_band_ind": 7,
            "sched_info_list": [{"si_periodicity":
                                 SI_PERIOD[self.si_periodicity],
                                 "sib_map_info": []}],
            "si_win_len": "ms40",
            "sys_info_value_tag": 0})

    @staticmethod
    def from_tree(t):
        cell = t["cell_access_related_info"]
        per_name = t["sched_info_list"][0]["si_periodicity"]
        return Sib1(plmn=_plmn_from_tree(cell["plmn_id_list"][0]["plmn_id"]),
                    tac=cell["tac"], cell_id=cell["cell_id"],
                    si_periodicity=int(per_name[2:]))


@dataclass
class Sib2:
    """SystemInformationBlockType2 carried in a SystemInformation message:
    the common radio resource config a UE must acquire before RACH
    (36.331 §6.3.1).  The parametrized fields are the ones the stack
    actually derives live config from (PRACH geometry, N(1)_PUCCH);
    everything else packs with spec-sane defaults."""

    root_seq_idx: int = 0
    prach_cfg_idx: int = 3  # 36.211 table 5.7.1-2: format 0, any SFN, sf 1
    zero_corr_cfg: int = 7
    prach_freq_offset: int = 0
    n1_pucch_an: int = 12

    _channel = "bcch"

    # 36.211 table 5.7.1-2 (format 0, any-SFN rows): cfg idx -> PRACH sf
    _PRACH_SF = {3: 1, 4: 4, 5: 7}

    @property
    def prach_sf(self) -> int:
        """FDD PRACH subframe for the configured index (single-subframe,
        any-SFN format-0 indices; others are out of this stack's scope)."""
        try:
            return self._PRACH_SF[self.prach_cfg_idx]
        except KeyError:
            raise ValueError(
                f"unsupported prach-ConfigIndex {self.prach_cfg_idx}")

    def prach_config(self, params):
        """Live PrachConfig derived from this SIB2 (single place: the UE's
        SI handler, cell switches, and the eNB all share this mapping)."""
        from ..phy.phch.prach import PrachConfig

        return PrachConfig(params, root_seq_idx=self.root_seq_idx,
                           zero_corr_cfg=self.zero_corr_cfg,
                           freq_offset_prb=self.prach_freq_offset)

    def to_tree(self):
        sib2 = {
            "rr_cfg_common": {
                "rach_cfg_common": {
                    "preamb_info": {"nof_ra_preambs": "n64"},
                    "pwr_ramp_params": {
                        "pwr_ramp_step": "dB2",
                        "preamb_init_rx_target_pwr": "dBm_104"},
                    "ra_supervision_info": {
                        "preamb_trans_max": "n10",
                        "ra_resp_win_size": "sf10",
                        "mac_contention_resolution_timer": "sf64"},
                    "max_harq_msg3_tx": 4},
                "bcch_cfg": {"mod_period_coeff": "n4"},
                "pcch_cfg": {"default_paging_cycle": "rf32", "nb": "one_t"},
                "prach_cfg": {
                    "root_seq_idx": self.root_seq_idx,
                    "prach_cfg_info": {
                        "prach_cfg_idx": self.prach_cfg_idx,
                        "high_speed_flag": False,
                        "zero_correlation_zone_cfg": self.zero_corr_cfg,
                        "prach_freq_offset": self.prach_freq_offset}},
                "pdsch_cfg_common": {"ref_sig_pwr": 0, "p_b": 0},
                "pusch_cfg_common": {
                    "pusch_cfg_basic": {
                        "n_sb": 1, "hop_mode": "inter_sub_frame",
                        "pusch_hop_offset": 0, "enable64_qam": True},
                    "ul_ref_sigs_pusch": {
                        "group_hop_enabled": False, "group_assign_pusch": 0,
                        "seq_hop_enabled": False, "cyclic_shift": 0}},
                "pucch_cfg_common": {"delta_pucch_shift": "ds1",
                                     "n_rb_cqi": 0, "n_cs_an": 0,
                                     "n1_pucch_an": self.n1_pucch_an},
                "srs_ul_cfg_common": ("release", None),
                "ul_pwr_ctrl_common": {
                    "p0_nominal_pusch": -85, "alpha": "al07",
                    "p0_nominal_pucch": -105,
                    "delta_flist_pucch": {
                        "delta_f_pucch_format1": "deltaF0",
                        "delta_f_pucch_format1b": "deltaF3",
                        "delta_f_pucch_format2": "deltaF0",
                        "delta_f_pucch_format2a": "deltaF0",
                        "delta_f_pucch_format2b": "deltaF0"},
                    "delta_preamb_msg3": 4},
                "ul_cp_len": "len1"},
            "ue_timers_and_consts": {
                "t300": "ms1000", "t301": "ms1000", "t310": "ms1000",
                "n310": "n10", "t311": "ms10000", "n311": "n1"},
            "freq_info": {"add_spec_emission": 1},
            "time_align_timer_common": "infinity"}
        return ("sys_info", {"crit_exts": (
            "sys_info_r8", {"sib_type_and_info": [("sib2", sib2)]})})

    @staticmethod
    def from_tree(t):
        for kind, sib in t["crit_exts"][1]["sib_type_and_info"]:
            if kind != "sib2":
                continue
            rr = sib["rr_cfg_common"]
            pr = rr["prach_cfg"]
            info = pr["prach_cfg_info"]
            return Sib2(
                root_seq_idx=pr["root_seq_idx"],
                prach_cfg_idx=info["prach_cfg_idx"],
                zero_corr_cfg=info["zero_correlation_zone_cfg"],
                prach_freq_offset=info["prach_freq_offset"],
                n1_pucch_an=rr["pucch_cfg_common"]["n1_pucch_an"])
        return None


@dataclass
class Paging:
    """PCCH Paging: S-TMSI paging records (36.331 6.2.2, PO/PF math with
    the caller per 36.304 7)."""

    records: tuple = ()  # of 32-bit m-tmsi ints

    _channel = "pcch"

    def to_tree(self):
        body = {}
        if self.records:
            body["paging_record_list"] = [
                {"ue_id": ("s_tmsi", {"mmec": 0, "m_tmsi": tmsi}),
                 "cn_domain": "ps"} for tmsi in self.records]
        return ("paging", body)

    @staticmethod
    def from_tree(t):
        return Paging(records=tuple(
            r["ue_id"][1]["m_tmsi"]
            for r in t.get("paging_record_list", [])
            if r["ue_id"][0] == "s_tmsi"))


@dataclass
class ConnectionRelease:
    """RRCConnectionRelease: cause name + optional EUTRA redirect."""

    cause: str = "other"  # name in REL_CAUSES
    redirect_earfcn: int = 0  # 0 = none

    _channel = "dl_dcch"

    def to_tree(self):
        r8 = {"release_cause": self.cause}
        if self.redirect_earfcn:
            r8["redirected_carrier_info"] = ("eutra", self.redirect_earfcn)
        return ("rrc_conn_release", {
            "rrc_transaction_id": 0,
            "crit_exts": ("c1", ("rrc_conn_release_r8", r8))})

    @staticmethod
    def from_tree(t):
        r8 = t["crit_exts"][1][1]
        redirect = r8.get("redirected_carrier_info", (None, 0))
        return ConnectionRelease(
            cause=r8["release_cause"],
            redirect_earfcn=redirect[1] if redirect[0] == "eutra" else 0)


# channel schema + the message types it carries (alternative name -> class)
CHANNELS = {
    "ul_ccch": (S.UL_CCCH_MESSAGE, {
        "rrc_conn_request": ConnectionRequest,
        "rrc_conn_reest_request": ReestablishmentRequest}),
    "dl_ccch": (S.DL_CCCH_MESSAGE, {
        "rrc_conn_setup": ConnectionSetup,
        "rrc_conn_reest": Reestablishment,
        "rrc_conn_reest_reject": ReestablishmentReject}),
    "ul_dcch": (S.UL_DCCH_MESSAGE, {
        "rrc_conn_setup_complete": ConnectionSetupComplete,
        "ul_info_transfer": UlInformationTransfer,
        "security_mode_complete": RrcSecurityModeComplete,
        "rrc_conn_recfg_complete": ConnectionReconfigurationComplete,
        "rrc_conn_reest_complete": ReestablishmentComplete,
        "meas_report": MeasurementReportMsg}),
    "dl_dcch": (S.DL_DCCH_MESSAGE, {
        "dl_info_transfer": DlInformationTransfer,
        "security_mode_cmd": RrcSecurityModeCommand,
        "rrc_conn_recfg": ConnectionReconfiguration,
        "rrc_conn_release": ConnectionRelease}),
    "bcch": (S.BCCH_DL_SCH_MESSAGE, {"sib_type1": Sib1, "sys_info": Sib2}),
    "pcch": (S.PCCH_MESSAGE, {"paging": Paging}),
}

_TYPE_CHANNEL = {cls: ch for ch, (_, m) in CHANNELS.items()
                 for cls in m.values()}


def rrc_pack(msg) -> bytes:
    schema, _ = CHANNELS[_TYPE_CHANNEL[type(msg)]]
    return schema.to_bytes({"msg": ("c1", msg.to_tree())})


def rrc_unpack(raw: bytes, channel: str):
    """Decode the PER message delivered on `channel`; returns the dataclass
    (or (kind, tree) for message kinds no dataclass models)."""
    schema, types = CHANNELS[channel]
    v = schema.unpack(BitReader(raw))
    kind, tree = v["msg"][1]
    cls = types.get(kind)
    return cls.from_tree(tree) if cls else (kind, tree)
