"""The port's TUN gateways against the kernel's IP stack, on the CPU.

Analogs of tests/test_tun.py on `srslte_tpu_torch.net.tun`, skipped by the
same condition (root and /dev/net/tun): the kernel answers ICMP echo
through the UE's TUN, through the SGi TUN behind the port's wire EpcApp
after the port's apps attach over the air (6 PRB, `device="cpu"`), and on a
raw device.  The subnets and device names are the port's own (10.45.78.0/24,
10.45.89.0/30, the SGi pool 172.31.78, `tun_pt%d`, `sgi_pt%d`, `tun_prt%d`),
so these tests run beside the reference's without a route colliding.
"""

import socket
import struct

import pytest
import torch

from srslte_tpu_torch.net.tun import SpgwSgi, TunDevice, UeGw, ipv4_dst, tun_available

pytestmark = pytest.mark.skipif(not tun_available(), reason="needs root + /dev/net/tun")

torch.set_num_threads(1)  # several test workers share the machine's cores


def _cksum(b: bytes) -> int:
    if len(b) % 2:
        b += b"\0"
    s = sum(struct.unpack(f"!{len(b) // 2}H", b))
    s = (s >> 16) + (s & 0xFFFF)
    s += s >> 16
    return ~s & 0xFFFF


def icmp_echo_request(src: str, dst: str, ident: int = 0x1234, seq: int = 1,
                      payload: bytes = b"tpu-ping") -> bytes:
    icmp = struct.pack("!BBHHH", 8, 0, 0, ident, seq) + payload
    icmp = icmp[:2] + struct.pack("!H", _cksum(icmp)) + icmp[4:]
    iph = struct.pack("!BBHHHBBH4s4s", 0x45, 0, 20 + len(icmp), 0, 0, 64, 1,
                      0, socket.inet_aton(src), socket.inet_aton(dst))
    iph = iph[:10] + struct.pack("!H", _cksum(iph)) + iph[12:]
    return iph + icmp


def is_icmp_echo_reply(pkt: bytes) -> bool:
    if len(pkt) < 28 or pkt[0] >> 4 != 4 or pkt[9] != 1:
        return False
    return pkt[(pkt[0] & 0xF) * 4] == 0


def test_ue_gw_kernel_echo():
    """An echo request to the TUN's own address: the kernel answers and
    routes the reply back out through the TUN."""

    class FakeUe:
        def __init__(self):
            self.rx_data, self.sent = [], []

        def send_data(self, pkt):
            self.sent.append(pkt)

    ue = FakeUe()
    gw = UeGw(ue, "10.45.78.2", name="tun_pt%d")
    try:
        ue.rx_data.append(icmp_echo_request("10.45.78.9", "10.45.78.2"))
        gw.step()
        reply = None
        for _ in range(200):
            gw.step()
            for pkt in ue.sent:
                if is_icmp_echo_reply(pkt) and ipv4_dst(pkt) == "10.45.78.9":
                    reply = pkt
            if reply:
                break
        assert reply is not None, "kernel never answered through the UE TUN"
    finally:
        gw.close()


def test_sgi_tun_kernel_echo_over_the_air():
    """The port's UE attaches over the air through the port's wire EpcApp,
    then pings the SGi gateway: DRB -> eNB -> GTP-U -> SPGW -> SGi TUN, the
    kernel's reply back down to the UE's DRB."""
    from srslte_tpu_torch.enb import EnbApp
    from srslte_tpu_torch.epc import Hss
    from srslte_tpu_torch.epc.wire import EpcApp
    from srslte_tpu_torch.phy.common.params import Cell
    from srslte_tpu_torch.security.milenage import compute_opc
    from srslte_tpu_torch.ue import UeApp
    from srslte_tpu_torch.ue_stack import SoftUsim, UeNas

    imsi = "001010123456789"
    k = bytes.fromhex("465b5ce8b199b49faa5f0a2ee238a6bc")
    op = bytes.fromhex("cdc202d5123e20f62b6d676ac72cb318")
    hss = Hss()
    hss.add_subscriber(imsi, k, op=op)
    epc = EpcApp(hss, force_tcp=True)
    epc.mme.s11.settimeout(5.0)  # a fault fails the test instead of hanging it
    epc.spgw.table.ip_base = "172.31.78"  # private pool: UE = 172.31.78.2
    sgi = SpgwSgi(epc.spgw, gw_ip="172.31.78.1", name="sgi_pt%d")
    try:
        cell = Cell(n_prb=6, id=1, nof_ports=1)
        enb = EnbApp(cell, s1={"port": epc.s1_port, "force_tcp": True}, device="cpu")
        ue = UeApp(cell, UeNas(SoftUsim(imsi, k, compute_opc(k, op))), device="cpu")

        def step(tti):
            ue.rx_subframe(enb.tx_subframe(tti), tti)
            enb.rx_subframe(ue.tx_subframe(tti), tti)
            epc.step()
            sgi.step()

        tti = 0
        while tti < 400 and ue.nas.state != "attached":
            step(tti)
            tti += 1
        assert ue.nas.state == "attached"
        for _ in range(30):  # settle the DRB
            step(tti)
            tti += 1

        ue.send_data(icmp_echo_request(ue.nas.ip, "172.31.78.1"))
        reply = None
        while tti < 800 and reply is None:
            step(tti)
            tti += 1
            for pkt in ue.rx_data:
                if is_icmp_echo_reply(pkt):
                    reply = pkt
        assert reply is not None, "no ICMP reply from the kernel via sgi TUN"
        assert ipv4_dst(reply) == ue.nas.ip
    finally:
        sgi.close()
        epc.close()


def test_tun_device_roundtrip():
    """Raw device sanity: both gateway classes share this path."""
    t = TunDevice("tun_prt%d")
    try:
        t.configure("10.45.89.1", prefix=30)
        t.write_packet(icmp_echo_request("10.45.89.2", "10.45.89.1"))
        got = []
        for _ in range(200):
            got += t.read_packets()
            if any(is_icmp_echo_reply(p) for p in got):
                break
        assert any(is_icmp_echo_reply(p) for p in got)
    finally:
        t.close()
