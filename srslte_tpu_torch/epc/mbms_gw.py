"""MBMS gateway: SGi-mb ingress -> GTP-U over the M1-U interface
(srsepc/src/mbms-gw/mbms-gw.cc equivalent).

Reference behavior: IP packets entering on the sgi_mb TUN are wrapped in
GTP-U (fixed broadcast TEID) and sent on a UDP socket toward the eNB's
M1-U address (multicast 239.255.0.1:2152 in the reference's config); the
eNB side unwraps and feeds the PMCH/MBSFN scheduler.  Here the SGi-mb
ingress is an API call (or the TUN device via net/tun.py when running as a
process) and M1-U runs over any UDP address — loopback in tests, multicast
in deployment.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass, field

from ..gtpu import GtpuHeader, gtpu_pack, gtpu_unpack

M1U_PORT = 2152
MBMS_TEID = 0x1


@dataclass
class MbmsGw:
    """Sends SGi-mb IP packets as GTP-U toward the eNB M1-U address."""

    m1u_addr: str = "127.0.0.1"
    m1u_port: int = M1U_PORT
    teid: int = MBMS_TEID

    def __post_init__(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        if self.m1u_addr.split(".")[0].isdigit() and \
                224 <= int(self.m1u_addr.split(".")[0]) <= 239:
            self._sock.setsockopt(socket.IPPROTO_IP,
                                  socket.IP_MULTICAST_TTL, 1)
        self.pkts_tx = 0

    def sgi_mb_rx(self, ip_packet: bytes):
        """One downlink multicast IP packet -> GTP-U on M1-U."""
        pdu = gtpu_pack(GtpuHeader(teid=self.teid), ip_packet)
        self._sock.sendto(pdu, (self.m1u_addr, self.m1u_port))
        self.pkts_tx += 1

    def close(self):
        self._sock.close()


@dataclass
class EnbM1uRx:
    """eNB-side M1-U receiver: unwraps GTP-U into MCH payloads
    (srsenb mch handling analog)."""

    bind_addr: str = "127.0.0.1"
    port: int = M1U_PORT
    queue: list = field(default_factory=list)

    def __post_init__(self):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self.bind_addr, self.port))
        self._sock.setblocking(False)

    def poll(self) -> list[bytes]:
        """Drain received multicast IP packets (GTP-U unwrapped)."""
        out = []
        while True:
            try:
                raw, _ = self._sock.recvfrom(4096)
            except BlockingIOError:
                break
            hdr, payload = gtpu_unpack(raw)
            if hdr.teid == MBMS_TEID:
                out.append(payload)
        self.queue.extend(out)
        return out

    def close(self):
        self._sock.close()
