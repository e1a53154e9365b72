"""TTCN3 system-simulator (SS) interface: JSON-over-TCP ports driving the
unmodified UE stack over an ideal PHY.

Reference behavior: srsue/test/ttcn3/ — the SS wraps the real srsUE
upper-layer stack with `lte_ttcn3_phy` (an ideal PHY) and exposes the
TS 36.523-3 tester interfaces as TCP ports carrying JSON documents:
  - UT  (ttcn3_ut_interface.h):  MMI commands (SWITCH_ON / POWER_OFF ...)
  - SYS (ttcn3_sys_interface.h): cell configuration + timing enquiries
  - SRB (ttcn3_srb_interface.h): CCCH/DCCH RRC PDUs with RoutingInfo

Divergences (semantics parity, not byte parity): every message
is one length-prefixed (u32 BE) JSON document, with RRC PDUs carried as a
hex string INSIDE the JSON (`RrcPdu.Ccch/Dcch`) instead of the reference's
raw-bytes-after-JSON concatenation; the ideal PHY is direct MAC-PDU
injection into `ue.UeApp._handle_dlsch` / extraction from `_build_ul_mac`,
so no device compute runs under the SS at all.
"""

from __future__ import annotations

import json
import socket
import struct
from dataclasses import dataclass, field

from .mac.pdu import DL_LCID, MacPdu, Rar, RarPdu
from .rlc.am import RlcAm
from .ue import MSG3_GRANT, RA_RNTI, UeApp


# ---------------------------------------------------------------- transport
class JsonPort:
    """One SS port: length-prefixed JSON documents over TCP."""

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.sock.settimeout(5.0)

    @staticmethod
    def listen(host: str = "127.0.0.1", port: int = 0):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(1)
        return srv

    @staticmethod
    def accept(srv: socket.socket) -> "JsonPort":
        conn, _ = srv.accept()
        return JsonPort(conn)

    @staticmethod
    def connect(host: str, port: int) -> "JsonPort":
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        s.connect((host, port))
        return JsonPort(s)

    def send(self, doc: dict):
        raw = json.dumps(doc).encode()
        self.sock.sendall(struct.pack(">I", len(raw)) + raw)

    def recv(self) -> dict:
        hdr = self._read(4)
        (n,) = struct.unpack(">I", hdr)
        return json.loads(self._read(n).decode())

    def _read(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("SS port closed")
            buf += chunk
        return buf

    def close(self):
        self.sock.close()


# ---------------------------------------------------------------- helpers
def srb_msg(cell: str, srb: int, kind: str, pdu: bytes,
            follow_on: bool = False) -> dict:
    """Tester->SS / SS->tester SRB document (ttcn3_helpers.h shapes)."""
    return {
        "Common": {
            "CellId": cell,
            "RoutingInfo": {"RadioBearerId": {"Srb": srb}},
            "TimingInfo": "Now",
            "ControlInfo": {"CnfFlag": False, "FollowOnFlag": follow_on},
        },
        "RrcPdu": {kind: pdu.hex()},
    }


@dataclass
class SystemSimulator:
    """The SS proper: owns an unmodified UeApp, reacts to the three ports.

    Single-threaded: `serve_once(port_kind)` handles one document.  The
    ideal PHY is synchronous — UL MAC PDUs appear on the SRB port as soon
    as the UE queues them (ttcn3_syssim.cc tti_timer equivalent is the
    `tti` counter advanced by `pump_ul`).
    """

    ue: UeApp
    ut: JsonPort
    sys: JsonPort
    srb: JsonPort
    cell_name: str = "eutra_Cell1"
    tti: int = 0
    crnti: int = 0x46
    srb1_peer: RlcAm = field(default_factory=RlcAm)
    events: list = field(default_factory=list)

    # ---- UT port ----------------------------------------------------------
    def handle_ut(self):
        doc = self.ut.recv()
        cmd = doc.get("Cmd", {})
        if "MMI" in cmd:
            action = cmd["MMI"]["Cmd"]
            if action in ("SWITCH_ON", "POWER_ON"):
                self._switch_on()
            elif action in ("SWITCH_OFF", "POWER_OFF"):
                self.ue.state = "camped"
                self.ue.rrc_state = "idle"
            if doc.get("CnfRequired"):
                self.ut.send({"Cnf": {"MMI": {"Cmd": action, "Result": True}}})
        self.events.append(("ut", cmd))

    def _switch_on(self):
        """Ideal-PHY RA: skip the PRACH waveform, answer msg1 with a RAR
        so the UE's own FSM produces msg3 (lte_ttcn3_phy::prach_...)."""
        preamble = self.ue.ra.start()
        rar = RarPdu(rars=[Rar(rapid=preamble, ta=0, grant=0,
                               temp_crnti=self.crnti)])
        self.ue._handle_dlsch(RA_RNTI, rar.pack(), self.tti)
        self.pump_ul()

    # ---- SYS port ---------------------------------------------------------
    def handle_sys(self):
        doc = self.sys.recv()
        req = doc.get("Request", {})
        if "Cell" in req:
            self.cell_name = doc.get("Common", {}).get("CellId",
                                                       self.cell_name)
            self.sys.send({"Confirm": {"Cell": True}})
        elif "EnquireTiming" in req:
            self.sys.send({"Confirm": {"EnquireTiming": True},
                           "Time": {"SFN": self.tti // 10,
                                    "Subframe": self.tti % 10}})
        self.events.append(("sys", list(req)))

    # ---- SRB port ---------------------------------------------------------
    def handle_srb(self):
        doc = self.srb.recv()
        kind, hexpdu = next(iter(doc["RrcPdu"].items()))
        pdu = bytes.fromhex(hexpdu)
        if kind == "Ccch":
            # msg4: contention resolution CE + the CCCH SDU in one MAC PDU
            mac = MacPdu()
            mac.add_ce(int(DL_LCID.CON_RES_ID),
                       self.ue.ra._con_res_id)
            mac.add_sdu(0, pdu)
            self.ue._handle_dlsch(self.crnti, mac.pack(), self.tti)
        else:  # Dcch on SRB1: through the SS's peer RLC AM entity
            self.srb1_peer.write_sdu(pdu)
            mac = MacPdu()
            while self.srb1_peer.get_buffer_state() > 0:
                rlc_pdu = self.srb1_peer.read_pdu(120)
                if not rlc_pdu:
                    break
                mac.add_sdu(1, rlc_pdu)
            self.ue._handle_dlsch(self.crnti, mac.pack(), self.tti)
        self.pump_ul()

    # ---- ideal-PHY UL pump --------------------------------------------------
    def pump_ul(self, horizon: int = 12):
        """Advance TTIs; deliver every UL MAC PDU the UE queues to the
        tester as SRB documents (and grant UL when the UE has SRB data)."""
        for _ in range(horizon):
            self.tti += 1
            tx = self.ue.pending_ul.pop(self.tti, None)
            if tx is None:
                if (self.ue.crnti and self.ue.srb1.get_buffer_state() > 0
                        and not self.ue.pending_ul):
                    self.ue._queue_ul(self.tti + 1, MSG3_GRANT)
                continue
            if tx.kind != "pusch":
                continue
            tbs_bytes = tx.grant.tbs // 8
            payload = tx.payload or self.ue._build_ul_mac(tbs_bytes)
            self._route_ul(payload)

    def _route_ul(self, raw: bytes):
        mac = MacPdu.parse(raw, ul=True)
        for s in mac.subpdus:
            if s.lcid == 0 and s.payload:
                self.srb.send(srb_msg(self.cell_name, 0, "Ccch", s.payload))
            elif s.lcid == 1 and s.payload:
                self.srb1_peer.write_pdu(s.payload)
        while self.srb1_peer.rx_sdus:
            sdu = self.srb1_peer.rx_sdus.pop(0)
            self.srb.send(srb_msg(self.cell_name, 1, "Dcch", sdu))
