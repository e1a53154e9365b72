"""Process-separable EPC: S1AP/SCTP MME + GTP-C/GTP-U SPGW.

Reference behavior:
- srsepc/src/mme/s1ap*.cc — SCTP server, S1Setup, InitialUEMessage /
  NAS transport, InitialContextSetup carrying KeNB + E-RAB (attach accept
  piggybacked), UEContextRelease.
- srsepc/src/mme/mme_gtpc.cc:1-487 — GTP-C create/modify/delete session
  toward the SPGW over the S11 socket.
- srsepc/src/spgw/{gtpc.cc,gtpu.cc} — session table, S1-U GTP-U/UDP data
  plane (port 2152), SGi forwarding.

Everything is non-blocking and serviced by `step()` so an EpcApp can run
inside a test loop or in a process of its own that calls `step()` in a
loop; the eNB side lives in enb_s1.py (EnbS1).
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field

from ..nas.keys import kdf_kenb
from ..net.s1_transport import GtpuSocket, S1Server
from ..s1ap import s1ap_pack, s1ap_unpack
from . import gtpc
from .hss import Hss
from .mme import Mme, UeContext
from .spgw import Spgw

PLMN = b"\x00\xf1\x10"
TAC = b"\x00\x07"


class SpgwApp:
    """SPGW with real S11 (GTP-C) and S1-U (GTP-U) UDP sockets."""

    def __init__(self, host: str = "127.0.0.1", sgi_tx=None):
        self.table = Spgw(sgi_tx=sgi_tx)
        self.s11 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.s11.bind((host, 0))
        self.s11.setblocking(False)
        self.s11_addr = self.s11.getsockname()
        self.gtpu = GtpuSocket(host)
        self.enb_addr: dict[int, tuple] = {}  # teid_dl -> eNB GTP-U addr
        self.dl_teid: dict[str, int] = {}     # ue_ip -> teid_dl

    # -- S11 control plane -------------------------------------------------
    def service_s11(self):
        while True:
            try:
                raw, addr = self.s11.recvfrom(65536)
            except (BlockingIOError, OSError):
                break
            pdu = gtpc.GtpcPdu.unpack(raw)
            resp = self._handle_s11(pdu)
            if resp is not None:
                self.s11.sendto(resp.pack(), addr)

    def _handle_s11(self, pdu: gtpc.GtpcPdu) -> gtpc.GtpcPdu | None:
        if pdu.msg_type == gtpc.CREATE_SESSION_REQUEST:
            tun = self.table.create_session(str(pdu.imsi), teid_dl=0)
            return gtpc.GtpcPdu(
                gtpc.CREATE_SESSION_RESPONSE, teid=pdu.mme_ctrl_teid,
                sequence=pdu.sequence, imsi=pdu.imsi, ebi=pdu.ebi,
                user_fteid=gtpc.Fteid(tun.teid_ul, *self.gtpu.addr),
                paa=tun.ue_ip)
        if pdu.msg_type == gtpc.MODIFY_BEARER_REQUEST:
            # eNB S1-U F-TEID for the downlink direction
            tun = self.table.by_teid_ul.get(pdu.teid)
            if tun is not None and pdu.user_fteid is not None:
                tun.teid_dl = pdu.user_fteid.teid
                self.enb_addr[pdu.user_fteid.teid] = (
                    pdu.user_fteid.ipv4, pdu.user_fteid.port)
                self.dl_teid[tun.ue_ip] = pdu.user_fteid.teid
            return gtpc.GtpcPdu(gtpc.MODIFY_BEARER_RESPONSE, teid=pdu.teid,
                                sequence=pdu.sequence, ebi=pdu.ebi)
        if pdu.msg_type == gtpc.DELETE_SESSION_REQUEST:
            tun = self.table.by_teid_ul.pop(pdu.teid, None)
            if tun is not None:
                self.table.by_ue_ip.pop(tun.ue_ip, None)
                self.dl_teid.pop(tun.ue_ip, None)
            return gtpc.GtpcPdu(gtpc.DELETE_SESSION_RESPONSE, teid=pdu.teid,
                                sequence=pdu.sequence)
        return None

    # -- S1-U data plane ---------------------------------------------------
    def service_gtpu(self):
        for raw, addr in self.gtpu.poll():
            self.table.rx_s1u(raw)

    def send_dl(self, ue_ip: str, packet: bytes) -> bool:
        """SGi -> UE: wrap in a G-PDU toward the eNB (spgw/gtpu.cc:226)."""
        raw = self.table.tx_sgi(ue_ip, packet)
        teid_dl = self.dl_teid.get(ue_ip)
        if raw is None or teid_dl not in self.enb_addr:
            return False
        host, port = self.enb_addr[teid_dl]
        self.gtpu.send(raw, (host, port))
        return True

    def step(self):
        self.service_s11()
        self.service_gtpu()

    def close(self):
        self.s11.close()
        self.gtpu.close()


@dataclass
class S1UeCtx:
    enb_ue_id: int
    mme_ue_id: int
    assoc: object
    nas_ue_id: int
    erab_teid_ul: int = 0
    awaiting_session: bytes = b""  # attach-accept NAS held for the ICS


class MmeS1(Mme):
    """MME speaking S1AP to eNBs and GTP-C to the SPGW."""

    def __init__(self, hss: Hss, spgw_s11_addr, host: str = "127.0.0.1",
                 s1_port: int = 0, force_tcp: bool = False, kick=None):
        super().__init__(hss, spgw=None)
        self.server = S1Server(host, s1_port, force_tcp)
        self.s11 = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.s11.bind((host, 0))
        self.s11.settimeout(2.0)
        self.spgw_s11_addr = spgw_s11_addr
        self.kick = kick  # co-located SPGW servicer (single-process mode)
        self.next_mme_ue_id = 1
        self.s1_ues: dict[int, S1UeCtx] = {}  # mme_ue_id -> ctx
        self._gtpc_seq = 1
        self._sessions: dict[int, tuple] = {}  # mme_ue_id -> (ip, teid_ul)

    # -- GTP-C client (mme_gtpc.cc) ---------------------------------------
    def _gtpc_exchange(self, pdu: gtpc.GtpcPdu) -> gtpc.GtpcPdu:
        self.s11.sendto(pdu.pack(), self.spgw_s11_addr)
        if self.kick is not None:
            self.kick()
        raw, _ = self.s11.recvfrom(65536)
        return gtpc.GtpcPdu.unpack(raw)

    def _create_session(self, ctx: UeContext) -> tuple[str, int]:
        seq = self._gtpc_seq
        self._gtpc_seq += 1
        resp = self._gtpc_exchange(gtpc.GtpcPdu(
            gtpc.CREATE_SESSION_REQUEST, sequence=seq,
            imsi=int(ctx.imsi), mme_ctrl_teid=seq))
        assert resp.msg_type == gtpc.CREATE_SESSION_RESPONSE
        ue_id = next(k for k, v in self.ues.items() if v is ctx)
        self._sessions[ue_id] = (resp.paa, resp.user_fteid)
        return resp.paa, resp.user_fteid.teid

    def modify_bearer(self, teid_ul: int, enb_teid_dl: int, enb_ip: str,
                      enb_port: int):
        resp = self._gtpc_exchange(gtpc.GtpcPdu(
            gtpc.MODIFY_BEARER_REQUEST, teid=teid_ul,
            user_fteid=gtpc.Fteid(enb_teid_dl, enb_ip, enb_port)))
        assert resp.msg_type == gtpc.MODIFY_BEARER_RESPONSE

    # -- S1AP server -------------------------------------------------------
    def step(self):
        for assoc, raw in self.server.poll():
            proc, ies = s1ap_unpack(raw)
            handler = getattr(self, f"_on_{proc}", None)
            if handler is not None:
                handler(assoc, ies)

    def _on_s1_setup_request(self, assoc, ies):
        assoc.send(s1ap_pack("s1_setup_response", {
            "mme_name": "srsmme01",
            "served_gummeis": [{"plmns": [PLMN],
                                "group_ids": [b"\x00\x01"],
                                "mmecs": [b"\x1a"]}],
            "relative_mme_capacity": 255}))

    def _nas_to_ue(self, s1ue: S1UeCtx, dl_pdus: list):
        ctx = self.ues[s1ue.nas_ue_id]
        for dl in dl_pdus:
            if ctx.state == "attached" and not s1ue.erab_teid_ul:
                # this DL NAS is the attach accept: deliver inside
                # InitialContextSetupRequest (s1ap_nas_transport.cc)
                ip, fteid = self._sessions[s1ue.mme_ue_id]
                s1ue.erab_teid_ul = fteid.teid
                kenb = kdf_kenb(ctx.kasme, 0)
                s1ue.assoc.send(s1ap_pack("initial_context_setup_request", {
                    "mme_ue_id": s1ue.mme_ue_id,
                    "enb_ue_id": s1ue.enb_ue_id,
                    "ue_aggregate_max_bitrate": {"dl": 10**9, "ul": 10**9},
                    "erab_to_be_setup_list": [{"item": {
                        "erab_id": 5,
                        "qos": {"qci": 9, "arp": {
                            "priority_level": 15,
                            "pre_emption_capability": "shall_not_trigger",
                            "pre_emption_vulnerability": "not_pre_emptable"}},
                        "transport_address": (int.from_bytes(
                            socket.inet_aton(fteid.ipv4), "big"), 32),
                        "gtp_teid": fteid.teid.to_bytes(4, "big"),
                        "nas_pdu": dl}}],
                    "ue_security_capabilities": {
                        "eea": 0b1100000000000000, "eia": 0b1100000000000000},
                    "security_key": int.from_bytes(kenb, "big"),
                    # SPGW GTP-U UDP port (ephemeral under test; the
                    # standard pins 2152) as a raw private-range IE
                    "_raw_401": ("ignore", fteid.port.to_bytes(2, "big"))}))
            else:
                s1ue.assoc.send(s1ap_pack("downlink_nas_transport", {
                    "mme_ue_id": s1ue.mme_ue_id,
                    "enb_ue_id": s1ue.enb_ue_id, "nas_pdu": dl}))

    def _on_initial_ue_message(self, assoc, ies):
        mme_ue_id = self.next_mme_ue_id
        self.next_mme_ue_id += 1
        s1ue = S1UeCtx(enb_ue_id=ies["enb_ue_id"], mme_ue_id=mme_ue_id,
                       assoc=assoc, nas_ue_id=mme_ue_id)
        self.s1_ues[mme_ue_id] = s1ue
        self._nas_to_ue(s1ue, self.rx_nas(s1ue.nas_ue_id, ies["nas_pdu"]))

    def _on_uplink_nas_transport(self, assoc, ies):
        s1ue = self.s1_ues.get(ies["mme_ue_id"])
        if s1ue is None:
            return
        self._nas_to_ue(s1ue, self.rx_nas(s1ue.nas_ue_id, ies["nas_pdu"]))

    def _on_initial_context_setup_response(self, assoc, ies):
        s1ue = self.s1_ues.get(ies["mme_ue_id"])
        if s1ue is None:
            return
        item = ies["erab_setup_list"][0]["item"]
        addr_int, nbits = item["transport_address"]
        enb_ip = socket.inet_ntoa(addr_int.to_bytes(4, "big"))
        teid_dl = int.from_bytes(item["gtp_teid"], "big")
        # GTP-U runs on ephemeral ports under test (the standard fixes
        # 2152); the eNB advertises its port in a private-range IE that
        # rides the response as a raw passthrough triplet
        enb_port = int.from_bytes(
            ies.get("_raw_400", (None, (2152).to_bytes(2, "big")))[1], "big")
        self.modify_bearer(s1ue.erab_teid_ul, teid_dl, enb_ip, enb_port)

    def _on_ue_context_release_request(self, assoc, ies):
        s1ue = self.s1_ues.get(ies["mme_ue_id"])
        if s1ue is None:
            return
        assoc.send(s1ap_pack("ue_context_release_command", {
            "ue_s1ap_ids": ("pair", {"mme_ue_id": s1ue.mme_ue_id,
                                     "enb_ue_id": s1ue.enb_ue_id}),
            "cause": ies["cause"]}))

    def _on_ue_context_release_complete(self, assoc, ies):
        s1ue = self.s1_ues.pop(ies["mme_ue_id"], None)
        if s1ue is not None and s1ue.erab_teid_ul:
            self._gtpc_exchange(gtpc.GtpcPdu(
                gtpc.DELETE_SESSION_REQUEST, teid=s1ue.erab_teid_ul))


class EpcApp:
    """srsepc analog: MME (S1AP+GTP-C) + SPGW (GTP-C+GTP-U), one process."""

    def __init__(self, hss: Hss, host: str = "127.0.0.1",
                 force_tcp: bool = False, sgi_tx=None):
        self.spgw = SpgwApp(host, sgi_tx=sgi_tx)
        self.mme = MmeS1(hss, self.spgw.s11_addr, host,
                         force_tcp=force_tcp, kick=self.spgw.service_s11)

    @property
    def s1_port(self) -> int:
        return self.mme.server.port

    def step(self):
        self.mme.step()
        self.spgw.step()

    def close(self):
        self.mme.server.close()
        self.mme.s11.close()
        self.spgw.close()
