"""MAC-LTE PCAP writer (mac_pcap.cc / pcap.c equivalent).

Reference behavior: lib/src/common/{pcap.c, mac_pcap_base.cc} — classic
pcap file format with the Wireshark mac-lte-framed encapsulation: each
packet is the MAC_LTE_START marker payload ("mac-lte") + tag-value headers
(radio type, direction, RNTI type/value, subframe) + the MAC PDU, wrapped
in a UDP/IP/Ethernet frame on port 9999 (udp-framing mode, CHANGELOG:12).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass

DLT_EN10MB = 1
MAC_LTE_START = b"mac-lte"
# mac-lte framing tags (packet-mac-lte.h conventions)
TAG_RNTI = 0x02
TAG_UEID = 0x03
TAG_SUBFRAME = 0x04
TAG_PAYLOAD = 0x01

DIR_UPLINK = 0
DIR_DOWNLINK = 1
RNTI_TYPE_C = 3


def _mac_lte_context(ue_id: int, rnti: int, tti: int,
                     direction: int) -> bytes:
    """mac-lte tag-value context block (packet-mac-lte.h conventions)."""
    return (bytes([1, direction, RNTI_TYPE_C])  # radio type FDD, dir, type
            + bytes([TAG_RNTI]) + struct.pack("!H", rnti)
            + bytes([TAG_UEID]) + struct.pack("!H", ue_id)
            + bytes([TAG_SUBFRAME]) + struct.pack("!H", tti % 10)
            + bytes([TAG_PAYLOAD]))


@dataclass
class MacPcapNet:
    """Live network export of mac-lte frames (mac_pcap_net.cc analog).

    Sends each framed MAC PDU as a UDP datagram to a listening Wireshark
    ("DLT_USER framing over UDP"); same payload bytes as MacPcap's file
    path, no file involved.
    """

    host: str = "127.0.0.1"
    port: int = 5847
    ue_id: int = 1

    def __post_init__(self):
        import socket

        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def write_pdu(self, pdu: bytes, rnti: int, tti: int,
                  direction: int = DIR_DOWNLINK):
        ctx = _mac_lte_context(self.ue_id, rnti, tti, direction)
        self._sock.sendto(MAC_LTE_START + ctx + pdu, (self.host, self.port))

    def close(self):
        self._sock.close()


@dataclass
class MacPcap:
    path: str
    ue_id: int = 1

    def __post_init__(self):
        self._f = open(self.path, "wb")
        # pcap global header: magic, v2.4, tz 0, sigfigs 0, snaplen, DLT
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  65535, DLT_EN10MB))

    def _udp_frame(self, payload: bytes) -> bytes:
        eth = bytes(12) + struct.pack("!H", 0x0800)
        ip_len = 20 + 8 + len(payload)
        ip = struct.pack("!BBHHHBBH4s4s", 0x45, 0, ip_len, 0, 0, 64, 17, 0,
                         bytes([127, 0, 0, 1]), bytes([127, 0, 0, 1]))
        udp = struct.pack("!HHHH", 9999, 9999, 8 + len(payload), 0)
        return eth + ip + udp + payload

    def write_pdu(self, pdu: bytes, rnti: int, tti: int,
                  direction: int = DIR_DOWNLINK):
        ctx = _mac_lte_context(self.ue_id, rnti, tti, direction)
        frame = self._udp_frame(MAC_LTE_START + ctx + pdu)
        ts = time.time()
        self._f.write(struct.pack("<IIII", int(ts), int((ts % 1) * 1e6),
                                  len(frame), len(frame)))
        self._f.write(frame)

    def close(self):
        self._f.close()


# ---------------------------------------------------------------------------
# NAS / S1AP / RLC writers (nas_pcap.cc, s1ap_pcap.cc, rlc_pcap.cc analogs)
# ---------------------------------------------------------------------------
NAS_LTE_DLT = 148
UDP_DLT = 149
S1AP_LTE_DLT = 150

RLC_LTE_START = b"rlc-lte"
RLC_TM_MODE, RLC_UM_MODE, RLC_AM_MODE = 1, 2, 4
CHANNEL_TYPE_SRB, CHANNEL_TYPE_DRB = 4, 5
_RLC_SN_LEN_TAG = 0x02
_RLC_DIR_TAG = 0x03
_RLC_PRIO_TAG = 0x04
_RLC_UEID_TAG = 0x05
_RLC_CHTYPE_TAG = 0x06
_RLC_CHID_TAG = 0x07
_RLC_PAYLOAD_TAG = 0x01


class _RawDltPcap:
    """Raw-PDU pcap at a Wireshark user DLT (pcap.c LTE_PCAP_*_WritePDU:
    packet = the PDU itself, no framing)."""

    def __init__(self, path: str, dlt: int):
        self._f = open(path, "wb")
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  65535, dlt))

    def write_pdu(self, pdu: bytes):
        ts = time.time()
        self._f.write(struct.pack("<IIII", int(ts), int((ts % 1) * 1e6),
                                  len(pdu), len(pdu)))
        self._f.write(pdu)

    def close(self):
        self._f.close()


class NasPcap(_RawDltPcap):
    """NAS-EPS capture (nas_pcap.cc, DLT 148: each packet is one NAS PDU)."""

    def __init__(self, path: str):
        super().__init__(path, NAS_LTE_DLT)


class S1apPcap(_RawDltPcap):
    """S1AP capture (s1ap_pcap.cc, DLT 150: each packet is one S1AP PDU)."""

    def __init__(self, path: str):
        super().__init__(path, S1AP_LTE_DLT)


@dataclass
class RlcPcap:
    """RLC-LTE capture (rlc_pcap.cc, UDP DLT 149 with the rlc-lte framing:
    dummy UDP header + "rlc-lte" + mode byte + tag-value context)."""

    path: str
    ue_id: int = 1

    def __post_init__(self):
        self._f = open(self.path, "wb")
        self._f.write(struct.pack("<IHHiIII", 0xA1B2C3D4, 2, 4, 0, 0,
                                  65535, UDP_DLT))

    def write_pdu(self, pdu: bytes, mode: int = RLC_AM_MODE,
                  direction: int = DIR_DOWNLINK, lcid: int = 1,
                  is_srb: bool = True, sn_length: int = 10,
                  priority: int = 0):
        ctx = RLC_LTE_START + bytes([mode])
        if mode == RLC_UM_MODE:
            ctx += bytes([_RLC_SN_LEN_TAG, sn_length])
        ctx += bytes([_RLC_DIR_TAG, direction, _RLC_PRIO_TAG, priority])
        ctx += bytes([_RLC_UEID_TAG]) + struct.pack("!H", self.ue_id)
        ch_type = CHANNEL_TYPE_SRB if is_srb else CHANNEL_TYPE_DRB
        ctx += bytes([_RLC_CHTYPE_TAG]) + struct.pack("!H", ch_type)
        ctx += bytes([_RLC_CHID_TAG]) + struct.pack("!H", lcid)
        ctx += bytes([_RLC_PAYLOAD_TAG])
        udp_len = 8 + len(ctx) + len(pdu)
        hdr = struct.pack("!HHHH", 0xDEAD, 0xBEEF, udp_len, 0xDEAD)
        frame = hdr + ctx + pdu
        ts = time.time()
        self._f.write(struct.pack("<IIII", int(ts), int((ts % 1) * 1e6),
                                  len(frame), len(frame)))
        self._f.write(frame)

    def close(self):
        self._f.close()
