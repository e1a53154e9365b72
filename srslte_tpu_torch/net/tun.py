"""TUN devices for the UE gateway and the SPGW SGi interface.

Reference behavior: srsue/src/stack/upper/gw.cc:396 (tun_alloc + ifconfig
of tun_srsue with the NAS-assigned address) and srsepc/src/spgw/gtpu.cc:105
(sgi TUN: downlink IP packets read from the kernel, encapsulated into
GTP-U).  Pure-Python ioctl path, no shelling out for the device itself;
address/route setup uses iproute2 (like the reference's ifconfig calls).

Requires root + /dev/net/tun; callers must gate on `tun_available()`.
"""

from __future__ import annotations

import fcntl
import os
import struct
import subprocess

IFF_TUN = 0x0001
IFF_NO_PI = 0x1000
TUNSETIFF = 0x400454CA


def tun_available() -> bool:
    if not os.path.exists("/dev/net/tun"):
        return False
    try:
        t = TunDevice("tun_probe%d")
        t.close()
        return True
    except OSError:
        return False


class TunDevice:
    """An IFF_TUN interface delivering raw IP packets via read/write."""

    def __init__(self, name: str = "tun_srs%d"):
        self.fd = os.open("/dev/net/tun", os.O_RDWR | os.O_NONBLOCK)
        ifr = struct.pack("16sH", name.encode(), IFF_TUN | IFF_NO_PI)
        r = fcntl.ioctl(self.fd, TUNSETIFF, ifr)
        self.name = struct.unpack("16sH", r)[0].rstrip(b"\0").decode()

    def configure(self, ip: str, prefix: int = 24, mtu: int = 1400):
        """Assign the address and bring the link up (gw.cc if_up path)."""
        subprocess.run(["ip", "addr", "add", f"{ip}/{prefix}",
                        "dev", self.name], check=True)
        subprocess.run(["ip", "link", "set", self.name, "up",
                        "mtu", str(mtu)], check=True)

    def add_route(self, subnet: str):
        subprocess.run(["ip", "route", "add", subnet, "dev", self.name],
                       check=True)

    def read_packets(self, max_packets: int = 64) -> list[bytes]:
        out = []
        for _ in range(max_packets):
            try:
                out.append(os.read(self.fd, 65536))
            except BlockingIOError:
                break
        return out

    def write_packet(self, packet: bytes):
        os.write(self.fd, packet)

    def close(self):
        os.close(self.fd)


def ipv4_dst(packet: bytes) -> str | None:
    """Destination address of an IPv4 packet (None for non-IPv4)."""
    if len(packet) < 20 or packet[0] >> 4 != 4:
        return None
    return ".".join(str(b) for b in packet[16:20])


def ipv4_src(packet: bytes) -> str | None:
    if len(packet) < 20 or packet[0] >> 4 != 4:
        return None
    return ".".join(str(b) for b in packet[12:16])


class UeGw:
    """srsue gw: DRB <-> tun_srsue (gw.cc).  Poll from the UE TTI loop."""

    def __init__(self, ue, ip: str, name: str = "tun_srsue%d"):
        self.ue = ue
        self.tun = TunDevice(name)
        self.tun.configure(ip, prefix=24)

    def step(self):
        for pkt in self.tun.read_packets():
            self.ue.send_data(pkt)  # UL: kernel -> DRB
        while self.ue.rx_data:
            self.tun.write_packet(self.ue.rx_data.pop(0))  # DL -> kernel

    def close(self):
        self.tun.close()


class SpgwSgi:
    """srsepc sgi: TUN <-> SPGW session table (spgw/gtpu.cc sgi path)."""

    def __init__(self, spgw_app, gw_ip: str = "172.16.0.1",
                 subnet: str = "172.16.0.0/24", name: str = "sgi_srs%d"):
        self.spgw = spgw_app
        self.tun = TunDevice(name)
        self.tun.configure(gw_ip, prefix=24)
        # DL: deliver SPGW-received UL packets nowhere (kernel handles
        # routing); UL from kernel to UEs via send_dl
        spgw_app.table.sgi_tx = self._ul_to_kernel

    def _ul_to_kernel(self, ue_ip: str, pkt: bytes):
        self.tun.write_packet(pkt)

    def step(self):
        for pkt in self.tun.read_packets():
            dst = ipv4_dst(pkt)
            if dst is not None:
                self.spgw.send_dl(dst, pkt)

    def close(self):
        self.tun.close()
