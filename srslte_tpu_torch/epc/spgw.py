"""SPGW: GTP-U tunnels + SGi forwarding (srsepc/src/spgw/).

Reference behavior: spgw/gtpu.cc — TEID allocation per bearer, S1-U G-PDU
encap/decap, SGi side modeled as a callback (the reference writes to a TUN
device; here the "internet" is injectable for tests).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..gtpu import GtpuHeader, gtpu_pack, gtpu_unpack


@dataclass
class Tunnel:
    imsi: str
    ue_ip: str
    teid_ul: int  # SPGW-side (eNB sends UL G-PDUs with this TEID)
    teid_dl: int  # eNB-side (SPGW sends DL G-PDUs with this TEID)


@dataclass
class Spgw:
    sgi_tx: object = None  # callback(ue_ip, packet) -> None ("internet" out)
    next_teid: int = 1
    by_teid_ul: dict = field(default_factory=dict)
    by_ue_ip: dict = field(default_factory=dict)
    next_ip: int = 2
    ip_base: str = "172.16.0"  # pool prefix (reference: sgi_if_addr config)

    def create_session(self, imsi: str, teid_dl: int) -> Tunnel:
        ue_ip = f"{self.ip_base}.{self.next_ip}"
        self.next_ip += 1
        t = Tunnel(imsi, ue_ip, teid_ul=self.next_teid, teid_dl=teid_dl)
        self.next_teid += 1
        self.by_teid_ul[t.teid_ul] = t
        self.by_ue_ip[ue_ip] = t
        return t

    def rx_s1u(self, raw: bytes):
        """UL G-PDU from the eNB -> SGi."""
        hdr, payload = gtpu_unpack(raw)
        t = self.by_teid_ul.get(hdr.teid)
        if t is None:
            return None
        if self.sgi_tx:
            self.sgi_tx(t.ue_ip, payload)
        return t.ue_ip, payload

    def tx_sgi(self, ue_ip: str, packet: bytes) -> bytes | None:
        """DL packet from SGi -> S1-U G-PDU toward the eNB."""
        t = self.by_ue_ip.get(ue_ip)
        if t is None:
            return None
        return gtpu_pack(GtpuHeader(teid=t.teid_dl), packet)
