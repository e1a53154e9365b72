"""eNB-side S1AP agent + S1-U GTP-U endpoint.

Reference behavior: srsenb/src/stack/upper/s1ap.cc (S1Setup, InitialUE,
NAS transport, InitialContextSetup handling with KeNB + piggybacked NAS,
UEContextRelease) and srsenb/src/stack/upper/gtpu.cc:53-95 (S1-U UDP
sockets, TEID-keyed DL demux).

The agent is polled from the eNB TTI loop (single-threaded rails); all
socket IO is non-blocking.
"""

from __future__ import annotations

import socket

from .net.s1_transport import GtpuSocket, S1Client
from .s1ap import s1ap_pack, s1ap_unpack

PLMN = b"\x00\xf1\x10"
TAC = b"\x00\x07"


class EnbS1:
    def __init__(self, enb, host: str = "127.0.0.1", port: int = 36412,
                 force_tcp: bool = False, enb_id: int = 0x19B):
        self.enb = enb
        self.cli = S1Client(host, port, force_tcp)
        self.gtpu = GtpuSocket("127.0.0.1")
        self.setup_done = False
        self.spgw_gtpu_addr: tuple | None = None
        self.by_enb_ue_id: dict[int, object] = {}
        self.by_teid_dl: dict[int, object] = {}
        self.cli.send(s1ap_pack("s1_setup_request", {
            "global_enb_id": {"plmn": PLMN, "enb_id": ("macro", enb_id)},
            "enb_name": "srsenb01",
            "supported_tas": [{"tac": TAC, "plmns": [PLMN]}],
            "default_paging_drx": "v128"}))

    # -- uplink (UE -> MME) -------------------------------------------------
    def ul_nas(self, ue, nas_pdu: bytes):
        tai = {"plmn": PLMN, "tac": TAC}
        cgi = {"plmn": PLMN, "cell_id": (self.enb.cell.id << 8) | 1}
        if ue.mme_ue_id < 0:
            self.by_enb_ue_id[ue.ue_id] = ue
            self.cli.send(s1ap_pack("initial_ue_message", {
                "enb_ue_id": ue.ue_id, "nas_pdu": nas_pdu, "tai": tai,
                "eutran_cgi": cgi, "establishment_cause": "mo_signalling"}))
        else:
            self.cli.send(s1ap_pack("uplink_nas_transport", {
                "mme_ue_id": ue.mme_ue_id, "enb_ue_id": ue.ue_id,
                "nas_pdu": nas_pdu, "eutran_cgi": cgi, "tai": tai}))

    def ul_data(self, ue, packet: bytes):
        """Deciphered DRB SDU -> S1-U G-PDU toward the SPGW."""
        if self.spgw_gtpu_addr is None or not ue.teid_ul:
            return False
        from .gtpu import GtpuHeader, gtpu_pack

        self.gtpu.send(gtpu_pack(GtpuHeader(teid=ue.teid_ul), packet),
                       self.spgw_gtpu_addr)
        return True

    def release_request(self, ue, cause=("radio_network", "user_inactivity")):
        self.cli.send(s1ap_pack("ue_context_release_request", {
            "mme_ue_id": ue.mme_ue_id, "enb_ue_id": ue.ue_id,
            "cause": cause}))

    # -- downlink (MME -> UE) ----------------------------------------------
    def step(self):
        for raw in self.cli.poll():
            proc, ies = s1ap_unpack(raw)
            getattr(self, f"_on_{proc}", lambda i: None)(ies)
        for raw, _addr in self.gtpu.poll():
            from .gtpu import gtpu_unpack

            hdr, payload = gtpu_unpack(raw)
            ue = self.by_teid_dl.get(hdr.teid)
            if ue is not None and ue.pdcp_drb is not None:
                ue.drb1.write_sdu(ue.pdcp_drb.tx(payload))

    def _on_s1_setup_response(self, ies):
        self.setup_done = True

    def _ue(self, ies):
        ue = self.by_enb_ue_id.get(ies["enb_ue_id"])
        if ue is not None:
            ue.mme_ue_id = ies["mme_ue_id"]
        return ue

    def _on_downlink_nas_transport(self, ies):
        ue = self._ue(ies)
        if ue is not None:
            self.enb.dl_nas_to_ue(ue, ies["nas_pdu"])

    def _on_initial_context_setup_request(self, ies):
        ue = self._ue(ies)
        if ue is None:
            return
        ue.kenb = ies["security_key"].to_bytes(32, "big")
        item = ies["erab_to_be_setup_list"][0]["item"]
        ue.teid_ul = int.from_bytes(item["gtp_teid"], "big")
        addr_int, _ = item["transport_address"]
        port = int.from_bytes(
            ies.get("_raw_401", (None, (2152).to_bytes(2, "big")))[1], "big")
        self.spgw_gtpu_addr = (socket.inet_ntoa(addr_int.to_bytes(4, "big")),
                               port)
        nas = item.get("nas_pdu", b"")
        teid_dl = ue.ue_id
        self.by_teid_dl[teid_dl] = ue
        self.enb.start_as_security(ue, nas)
        my_ip, my_port = self.gtpu.addr
        self.cli.send(s1ap_pack("initial_context_setup_response", {
            "mme_ue_id": ue.mme_ue_id, "enb_ue_id": ue.ue_id,
            "erab_setup_list": [{"item": {
                "erab_id": item["erab_id"],
                "transport_address": (int.from_bytes(
                    socket.inet_aton(my_ip), "big"), 32),
                "gtp_teid": teid_dl.to_bytes(4, "big")}}],
            "_raw_400": ("ignore", my_port.to_bytes(2, "big"))}))

    def _on_ue_context_release_command(self, ies):
        kind, v = ies["ue_s1ap_ids"]
        mme_ue_id = v["mme_ue_id"] if kind == "pair" else v
        ue = next((u for u in self.by_enb_ue_id.values()
                   if u.mme_ue_id == mme_ue_id), None)
        if ue is not None:
            self.by_enb_ue_id.pop(ue.ue_id, None)
            self.by_teid_dl.pop(ue.ue_id, None)
            self.enb.release_ue(ue)
        self.cli.send(s1ap_pack("ue_context_release_complete", {
            "mme_ue_id": mme_ue_id,
            "enb_ue_id": ue.ue_id if ue is not None else 0}))
