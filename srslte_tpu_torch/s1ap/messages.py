"""S1AP (36.413) message schemas over ALIGNED PER.

Reference behavior: lib/src/asn1/s1ap.cc (generated 36.413 codecs) as used
by srsenb/src/stack/upper/s1ap.cc and srsepc/src/mme/s1ap*.cc.  Schemas
cover the S1 procedures the LTE attach / release / NAS-transport / context
paths exercise; byte-exactness is tested against the reference's committed
vectors (lib/test/asn1/s1ap_test.cc, srsenb/test/upper/s1ap_test.cc).

Encoding model:
  S1AP-PDU ::= CHOICE { initiatingMessage, successfulOutcome,
                        unsuccessfulOutcome, ... }
  each ::= SEQUENCE { procedureCode (0..255), criticality, value OPEN }
  message ::= SEQUENCE { protocolIEs SEQUENCE (SIZE(0..65535)) OF
                         SEQUENCE { id (0..65535), criticality, value OPEN } }

Python view: s1ap_pack(proc_name, {ie_name: value}) -> bytes and
s1ap_unpack(bytes) -> (proc_name, {ie_name: value}); IE values use the
rrc.per conventions (dicts / (name, value) tuples / ints / bytes).
"""

from __future__ import annotations

from ..rrc.per import BitReader, BitWriter, Type, _bits_for_range
from .aper import (ABitStr, AF, AInt, AOctStr, ASeqOf, AStr, OpenType,
                   achoice, aenum, aseq, get_length_det_aligned,
                   put_length_det_aligned)

# -------------------------------------------------------------- common IEs
PLMN = AOctStr(3, 3)
MME_UE_ID = AInt(0, 4294967295)
ENB_UE_ID = AInt(0, 16777215)
NAS_PDU = AOctStr()
TAC = AOctStr(2, 2)
BIT_RATE = AInt(0, 10_000_000_000)

TAI = aseq(AF("plmn", PLMN), AF("tac", TAC),
           AF("ie_ext", AOctStr(), optional=True), ext=True)
EUTRAN_CGI = aseq(AF("plmn", PLMN), AF("cell_id", ABitStr(28)),
                  AF("ie_ext", AOctStr(), optional=True), ext=True)

ENB_ID = achoice(("macro", ABitStr(20)), ("home", ABitStr(28)), ext=True)
GLOBAL_ENB_ID = aseq(AF("plmn", PLMN), AF("enb_id", ENB_ID),
                     AF("ie_ext", AOctStr(), optional=True), ext=True)

RRC_ESTABLISHMENT_CAUSE = aenum(
    "emergency", "high_priority_access", "mt_access", "mo_signalling",
    "mo_data", ext=True)

CAUSE_RADIO_NETWORK = aenum(
    "unspecified", "tx2relocoverall_expiry", "successful_handover",
    "release_due_to_eutran_generated_reason", "handover_cancelled",
    "partial_handover", "ho_failure_in_target_epc_enb_or_target_system",
    "ho_target_not_allowed", "ts1relocoverall_expiry", "ts1relocprep_expiry",
    "cell_not_available", "unknown_target_id",
    "no_radio_resources_available_in_target_cell", "unknown_mme_ue_s1ap_id",
    "unknown_enb_ue_s1ap_id", "unknown_pair_ue_s1ap_id",
    "handover_desirable_for_radio_reason", "time_critical_handover",
    "resource_optimisation_handover", "reduce_load_in_serving_cell",
    "user_inactivity", "radio_connection_with_ue_lost",
    "load_balancing_tau_required", "cs_fallback_triggered",
    "ue_not_available_for_ps_service", "radio_resources_not_available",
    "failure_in_radio_interface_procedure", "invalid_qos_combination",
    "interrat_redirection", "interaction_with_other_procedure",
    "unknown_erab_id", "multiple_erab_id_instances",
    "encryption_and_or_integrity_protection_algorithms_not_supported",
    "s1_intra_system_handover_triggered", "s1_inter_system_handover_triggered",
    "x2_handover_triggered", ext=True)
CAUSE_TRANSPORT = aenum("transport_resource_unavailable", "unspecified",
                        ext=True)
CAUSE_NAS = aenum("normal_release", "authentication_failure", "detach",
                  "unspecified", ext=True)
CAUSE_PROTOCOL = aenum(
    "transfer_syntax_error", "abstract_syntax_error_reject",
    "abstract_syntax_error_ignore_and_notify",
    "message_not_compatible_with_receiver_state", "semantic_error",
    "abstract_syntax_error_falsely_constructed_message", "unspecified",
    ext=True)
CAUSE_MISC = aenum(
    "control_processing_overload", "not_enough_user_plane_processing_resources",
    "hardware_failure", "om_intervention", "unspecified", "unknown_plmn",
    ext=True)
CAUSE = achoice(("radio_network", CAUSE_RADIO_NETWORK),
                ("transport", CAUSE_TRANSPORT), ("nas", CAUSE_NAS),
                ("protocol", CAUSE_PROTOCOL), ("misc", CAUSE_MISC), ext=True)

UE_AGGREGATE_MAX_BITRATE = aseq(
    AF("dl", BIT_RATE), AF("ul", BIT_RATE),
    AF("ie_ext", AOctStr(), optional=True), ext=True)

ALLOCATION_RETENTION_PRIORITY = aseq(
    AF("priority_level", AInt(0, 15)),
    AF("pre_emption_capability", aenum("shall_not_trigger", "may_trigger")),
    AF("pre_emption_vulnerability", aenum("not_pre_emptable",
                                          "pre_emptable")),
    AF("ie_ext", AOctStr(), optional=True), ext=True)

GBR_QOS_INFO = aseq(
    AF("erab_max_br_dl", BIT_RATE), AF("erab_max_br_ul", BIT_RATE),
    AF("erab_gbr_dl", BIT_RATE), AF("erab_gbr_ul", BIT_RATE),
    AF("ie_ext", AOctStr(), optional=True), ext=True)

ERAB_QOS_PARAMS = aseq(
    AF("qci", AInt(0, 255)), AF("arp", ALLOCATION_RETENTION_PRIORITY),
    AF("gbr_qos", GBR_QOS_INFO, optional=True),
    AF("ie_ext", AOctStr(), optional=True), ext=True)

TRANSPORT_ADDRESS = ABitStr(1, 160, ext=True)
GTP_TEID = AOctStr(4, 4)
ERAB_ID = AInt(0, 15, ext=True)

UE_SECURITY_CAPABILITIES = aseq(
    AF("eea", ABitStr(16, 16, ext=True)), AF("eia", ABitStr(16, 16, ext=True)),
    AF("ie_ext", AOctStr(), optional=True), ext=True)
SECURITY_KEY = ABitStr(256)

SERVED_GUMMEIS_ITEM = aseq(
    AF("plmns", ASeqOf(PLMN, 1, 32)),
    AF("group_ids", ASeqOf(AOctStr(2, 2), 1, 65535)),
    AF("mmecs", ASeqOf(AOctStr(1, 1), 1, 256)),
    AF("ie_ext", AOctStr(), optional=True), ext=True)
SERVED_GUMMEIS = ASeqOf(SERVED_GUMMEIS_ITEM, 1, 8)

SUPPORTED_TAS_ITEM = aseq(
    AF("tac", TAC), AF("plmns", ASeqOf(PLMN, 1, 6)),
    AF("ie_ext", AOctStr(), optional=True), ext=True)
SUPPORTED_TAS = ASeqOf(SUPPORTED_TAS_ITEM, 1, 256)

PAGING_DRX = aenum("v32", "v64", "v128", "v256", ext=True)

S_TMSI = aseq(AF("mmec", AOctStr(1, 1)), AF("m_tmsi", AOctStr(4, 4)),
              AF("ie_ext", AOctStr(), optional=True), ext=True)

GUMMEI = aseq(AF("plmn", PLMN), AF("group_id", AOctStr(2, 2)),
              AF("mmec", AOctStr(1, 1)),
              AF("ie_ext", AOctStr(), optional=True), ext=True)

UE_S1AP_ID_PAIR = aseq(AF("mme_ue_id", MME_UE_ID), AF("enb_ue_id", ENB_UE_ID),
                       AF("ie_ext", AOctStr(), optional=True), ext=True)
UE_S1AP_IDS = achoice(("pair", UE_S1AP_ID_PAIR), ("mme_ue_id", MME_UE_ID),
                      ext=True)

COUNT_VALUE = aseq(AF("pdcp_sn", AInt(0, 4095)), AF("hfn", AInt(0, 1048575)),
                   AF("ie_ext", AOctStr(), optional=True), ext=True)
BEARERS_STATUS_ITEM = aseq(
    AF("erab_id", ERAB_ID), AF("ul_count", COUNT_VALUE),
    AF("dl_count", COUNT_VALUE),
    AF("receive_status_of_ul_pdcp_sdus", ABitStr(4096), optional=True),
    AF("ie_ext", AOctStr(), optional=True), ext=True)


# ------------------------------------------- protocol-IE container machinery
REJECT, IGNORE, NOTIFY = "reject", "ignore", "notify"
_CRIT = (REJECT, IGNORE, NOTIFY)


class IeSpec:
    def __init__(self, ie_id: int, name: str, crit: str, typ: Type,
                 optional: bool = False):
        self.id, self.name, self.crit, self.typ = ie_id, name, crit, typ
        self.optional = optional


class Ies(Type):
    """ProtocolIE-Container: dict {name: value} <-> IE triplet sequence.

    Unknown IE ids decode to {"_raw_<id>": (crit, bytes)} and re-encode
    verbatim, so unmodelled optional IEs round-trip.
    """

    def __init__(self, *specs: IeSpec):
        self.specs = specs
        self.by_id = {s.id: s for s in specs}
        self.by_name = {s.name: s for s in specs}

    def pack(self, w: BitWriter, v: dict):
        items = []
        for s in self.specs:
            if s.name in v:
                items.append((s.id, s.crit, s.typ.to_bytes(v[s.name])))
            elif not s.optional:
                raise ValueError(f"missing mandatory IE {s.name}")
        for name, val in v.items():
            if name.startswith("_raw_"):
                items.append((int(name[5:]), val[0], val[1]))
        w.align()
        w.put(len(items), 16)
        for ie_id, crit, data in items:
            w.align()
            w.put(ie_id, 16)
            w.put(_CRIT.index(crit), 2)
            put_length_det_aligned(w, len(data))
            w.put_bytes(data)

    def unpack(self, r: BitReader) -> dict:
        r.align()
        n = r.get(16)
        out = {}
        for _ in range(n):
            r.align()
            ie_id = r.get(16)
            crit = _CRIT[r.get(2)]
            data = r.get_bytes(get_length_det_aligned(r))
            spec = self.by_id.get(ie_id)
            if spec is None:
                out[f"_raw_{ie_id}"] = (crit, data)
            else:
                out[spec.name] = spec.typ.from_bytes(data)
        return out


def _msg(*specs: IeSpec) -> Type:
    return aseq(AF("ies", Ies(*specs)), ext=True)


# --------------------------------------------------------------- procedures
# E-RAB items are themselves wrapped in ProtocolIE-SingleContainer
ERAB_TO_BE_SETUP_ITEM_CTXT = aseq(
    AF("erab_id", ERAB_ID), AF("qos", ERAB_QOS_PARAMS),
    AF("transport_address", TRANSPORT_ADDRESS), AF("gtp_teid", GTP_TEID),
    AF("nas_pdu", NAS_PDU, optional=True),
    AF("ie_ext", AOctStr(), optional=True), ext=True)
ERAB_SETUP_ITEM_CTXT = aseq(
    AF("erab_id", ERAB_ID), AF("transport_address", TRANSPORT_ADDRESS),
    AF("gtp_teid", GTP_TEID),
    AF("ie_ext", AOctStr(), optional=True), ext=True)
ERAB_ITEM = aseq(  # E-RABItem (failed E-RABs, 36.413 9.1.3.4)
    AF("erab_id", ERAB_ID), AF("cause", CAUSE),
    AF("ie_ext", AOctStr(), optional=True), ext=True)

ERAB_TO_BE_SETUP_LIST_CTXT = ASeqOf(
    Ies(IeSpec(52, "item", REJECT, ERAB_TO_BE_SETUP_ITEM_CTXT)), 1, 256)
ERAB_SETUP_LIST_CTXT = ASeqOf(
    Ies(IeSpec(50, "item", IGNORE, ERAB_SETUP_ITEM_CTXT)), 1, 256)
ERAB_FAILED_LIST = ASeqOf(
    Ies(IeSpec(35, "item", IGNORE, ERAB_ITEM)), 1, 256)


class _SingleIes(Ies):
    """ProtocolIE-SingleContainer: exactly one IE, no count prefix."""

    def pack(self, w, v: dict):
        (name, val), = v.items()
        s = self.by_name[name]
        data = s.typ.to_bytes(val)
        w.align()
        w.put(s.id, 16)
        w.put(_CRIT.index(s.crit), 2)
        put_length_det_aligned(w, len(data))
        w.put_bytes(data)

    def unpack(self, r):
        r.align()
        ie_id = r.get(16)
        crit = _CRIT[r.get(2)]
        data = r.get_bytes(get_length_det_aligned(r))
        spec = self.by_id.get(ie_id)
        if spec is None:
            return {f"_raw_{ie_id}": (crit, data)}
        return {spec.name: spec.typ.from_bytes(data)}


ERAB_TO_BE_SETUP_LIST_CTXT = ASeqOf(
    _SingleIes(IeSpec(52, "item", REJECT, ERAB_TO_BE_SETUP_ITEM_CTXT)), 1, 256)
ERAB_SETUP_LIST_CTXT = ASeqOf(
    _SingleIes(IeSpec(50, "item", IGNORE, ERAB_SETUP_ITEM_CTXT)), 1, 256)
ERAB_FAILED_LIST = ASeqOf(
    _SingleIes(IeSpec(35, "item", IGNORE, ERAB_ITEM)), 1, 256)
BEARERS_STATUS_LIST = ASeqOf(
    _SingleIes(IeSpec(89, "item", IGNORE, BEARERS_STATUS_ITEM)), 1, 256)

ENB_STATUS_TRANSFER_CONTAINER = aseq(
    AF("bearers", BEARERS_STATUS_LIST),
    AF("ie_ext", AOctStr(), optional=True), ext=True)


INITIATING, SUCCESSFUL, UNSUCCESSFUL = range(3)

# proc name -> (procedureCode, pdu kind, criticality, message schema)
PROCEDURES = {
    "s1_setup_request": (17, INITIATING, REJECT, _msg(
        IeSpec(59, "global_enb_id", REJECT, GLOBAL_ENB_ID),
        IeSpec(60, "enb_name", IGNORE, AStr(1, 150, ext=True), optional=True),
        IeSpec(64, "supported_tas", REJECT, SUPPORTED_TAS),
        IeSpec(137, "default_paging_drx", IGNORE, PAGING_DRX))),
    "s1_setup_response": (17, SUCCESSFUL, REJECT, _msg(
        IeSpec(61, "mme_name", IGNORE, AStr(1, 150, ext=True), optional=True),
        IeSpec(105, "served_gummeis", REJECT, SERVED_GUMMEIS),
        IeSpec(87, "relative_mme_capacity", IGNORE, AInt(0, 255)))),
    "s1_setup_failure": (17, UNSUCCESSFUL, REJECT, _msg(
        IeSpec(2, "cause", IGNORE, CAUSE),
        IeSpec(65, "time_to_wait", IGNORE,
               aenum("v1s", "v2s", "v5s", "v10s", "v20s", "v60s", ext=True),
               optional=True))),
    "initial_ue_message": (12, INITIATING, IGNORE, _msg(
        IeSpec(8, "enb_ue_id", REJECT, ENB_UE_ID),
        IeSpec(26, "nas_pdu", REJECT, NAS_PDU),
        IeSpec(67, "tai", REJECT, TAI),
        IeSpec(100, "eutran_cgi", IGNORE, EUTRAN_CGI),
        IeSpec(134, "establishment_cause", IGNORE, RRC_ESTABLISHMENT_CAUSE),
        IeSpec(96, "s_tmsi", REJECT, S_TMSI, optional=True),
        IeSpec(75, "gummei", REJECT, GUMMEI, optional=True))),
    "downlink_nas_transport": (11, INITIATING, IGNORE, _msg(
        IeSpec(0, "mme_ue_id", REJECT, MME_UE_ID),
        IeSpec(8, "enb_ue_id", REJECT, ENB_UE_ID),
        IeSpec(26, "nas_pdu", REJECT, NAS_PDU))),
    "uplink_nas_transport": (13, INITIATING, IGNORE, _msg(
        IeSpec(0, "mme_ue_id", REJECT, MME_UE_ID),
        IeSpec(8, "enb_ue_id", REJECT, ENB_UE_ID),
        IeSpec(26, "nas_pdu", REJECT, NAS_PDU),
        IeSpec(100, "eutran_cgi", IGNORE, EUTRAN_CGI),
        IeSpec(67, "tai", IGNORE, TAI))),
    "initial_context_setup_request": (9, INITIATING, REJECT, _msg(
        IeSpec(0, "mme_ue_id", REJECT, MME_UE_ID),
        IeSpec(8, "enb_ue_id", REJECT, ENB_UE_ID),
        IeSpec(66, "ue_aggregate_max_bitrate", REJECT,
               UE_AGGREGATE_MAX_BITRATE),
        IeSpec(24, "erab_to_be_setup_list", REJECT,
               ERAB_TO_BE_SETUP_LIST_CTXT),
        IeSpec(107, "ue_security_capabilities", REJECT,
               UE_SECURITY_CAPABILITIES),
        IeSpec(73, "security_key", REJECT, SECURITY_KEY))),
    "initial_context_setup_response": (9, SUCCESSFUL, REJECT, _msg(
        IeSpec(0, "mme_ue_id", IGNORE, MME_UE_ID),
        IeSpec(8, "enb_ue_id", IGNORE, ENB_UE_ID),
        IeSpec(51, "erab_setup_list", IGNORE, ERAB_SETUP_LIST_CTXT),
        IeSpec(48, "erab_failed_list", IGNORE, ERAB_FAILED_LIST,
               optional=True))),
    "ue_context_release_request": (18, INITIATING, IGNORE, _msg(
        IeSpec(0, "mme_ue_id", REJECT, MME_UE_ID),
        IeSpec(8, "enb_ue_id", REJECT, ENB_UE_ID),
        IeSpec(2, "cause", IGNORE, CAUSE))),
    "ue_context_release_command": (23, INITIATING, REJECT, _msg(
        IeSpec(99, "ue_s1ap_ids", REJECT, UE_S1AP_IDS),
        IeSpec(2, "cause", IGNORE, CAUSE))),
    "ue_context_release_complete": (23, SUCCESSFUL, REJECT, _msg(
        IeSpec(0, "mme_ue_id", IGNORE, MME_UE_ID),
        IeSpec(8, "enb_ue_id", IGNORE, ENB_UE_ID))),
    "enb_status_transfer": (24, INITIATING, IGNORE, _msg(
        IeSpec(0, "mme_ue_id", REJECT, MME_UE_ID),
        IeSpec(8, "enb_ue_id", REJECT, ENB_UE_ID),
        IeSpec(90, "container", REJECT, ENB_STATUS_TRANSFER_CONTAINER))),
}

_BY_CODE = {}
for _name, (_code, _kind, _crit, _schema) in PROCEDURES.items():
    _BY_CODE[(_code, _kind)] = (_name, _crit, _schema)


def s1ap_pack(proc: str, ies: dict) -> bytes:
    """Encode one S1AP PDU: procedure name + {ie_name: value}."""
    code, kind, crit, schema = PROCEDURES[proc]
    w = BitWriter()
    w.put(0, 1)  # S1AP-PDU extension bit
    w.put(kind, _bits_for_range(3))
    w.align()
    w.put(code, 8)
    w.put(_CRIT.index(crit), 2)
    data = schema.to_bytes({"ies": ies})
    put_length_det_aligned(w, len(data))
    w.put_bytes(data)
    return w.to_bytes()


def s1ap_unpack(data: bytes) -> tuple[str, dict]:
    """Decode one S1AP PDU -> (procedure name, {ie_name: value})."""
    r = BitReader(data)
    if r.get(1):
        raise NotImplementedError("extended S1AP-PDU alternative")
    kind = r.get(_bits_for_range(3))
    r.align()
    code = r.get(8)
    r.get(2)  # criticality
    n = get_length_det_aligned(r)
    body = r.get_bytes(n)
    entry = _BY_CODE.get((code, kind))
    if entry is None:
        raise ValueError(f"unknown S1AP procedure ({code}, {kind})")
    name, _, schema = entry
    return name, schema.from_bytes(body)["ies"]
