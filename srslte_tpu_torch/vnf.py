"""Basic VNF/PNF functional PHY split over UDP (NR slot granularity).

Reference behavior: lib/src/common/basic_vnf.cc + basic_vnf_api.h and the
srsue/srsenb vnf_phy_nr.cc shims — a FAPI-like "primitive API for basic
testing" that splits the PHY (PNF) from L2/L3 (VNF): the PNF announces each
slot (SF_IND), the VNF answers with DL_CONFIG.request + TX.request carrying
the MAC TB, and UL data returns as RX_DATA_IND (gNB) / DL_IND carries
decoded DL TBs to the UE stack.

The PNF side owns all device compute (the NR slot workers' encodes and
decodes on their device); the VNF side is pure host bytes (the L2
stacks).  The wire is length-prefixed little-endian structs over UDP —
semantics parity with basic_vnf_api.h message types, not byte-layout
compatibility (the reference ships raw C structs with padding).
"""

from __future__ import annotations

import socket
import struct
from dataclasses import dataclass, field

import numpy as np

# basic_vnf_api.h msg_type_t
SF_IND, DL_CONFIG, TX_REQUEST, RX_DATA_IND, DL_IND, UL_IND = range(6)
# pdu_type_t
MAC_PBCH, PHY_PBCH, PDCCH, PDSCH, PUSCH = range(5)

_HDR = struct.Struct("<II")  # type, msg_len (of the payload)


def _pack(msg_type: int, payload: bytes) -> bytes:
    return _HDR.pack(msg_type, len(payload)) + payload


def _unpack(dgram: bytes) -> tuple[int, bytes]:
    t, n = _HDR.unpack_from(dgram)
    body = dgram[_HDR.size : _HDR.size + n]
    if len(body) != n:
        raise ValueError(f"truncated VNF message type {t}")
    return t, body


def pack_sf_ind(t1: int, tti: int, tb_len: int) -> bytes:
    return _pack(SF_IND, struct.pack("<III", t1, tti, tb_len))


def pack_dl_config(t1: int, t2: int, tti: int, beam_id: int) -> bytes:
    return _pack(DL_CONFIG, struct.pack("<IIIH", t1, t2, tti, beam_id))


def pack_tx_request(tti: int, pdus: list[tuple[int, bytes]]) -> bytes:
    body = struct.pack("<III", tti, sum(len(d) for _, d in pdus), len(pdus))
    for i, (ptype, data) in enumerate(pdus):
        body += struct.pack("<HHI", len(data), i, ptype) + data
    return _pack(TX_REQUEST, body)


def unpack_tx_request(body: bytes) -> tuple[int, list[tuple[int, bytes]]]:
    tti, _, nof = struct.unpack_from("<III", body)
    off = 12
    pdus = []
    for _ in range(nof):
        ln, _, ptype = struct.unpack_from("<HHI", body, off)
        off += 8
        pdus.append((ptype, body[off : off + ln]))
        off += ln
    return tti, pdus


def pack_rx_data_ind(t1: int, sfn: int, slot: int,
                     pdus: list[tuple[int, bytes]]) -> bytes:
    body = struct.pack("<IIIII", t1, sfn, slot,
                       sum(len(d) for _, d in pdus), len(pdus))
    for ptype, data in pdus:
        body += struct.pack("<HI", len(data), ptype) + data
    return _pack(RX_DATA_IND, body)


def unpack_rx_data_ind(body: bytes):
    t1, sfn, slot, _, nof = struct.unpack_from("<IIIII", body)
    off = 20
    pdus = []
    for _ in range(nof):
        ln, ptype = struct.unpack_from("<HI", body, off)
        off += 6
        pdus.append((ptype, body[off : off + ln]))
        off += ln
    return sfn, slot, pdus


def pack_dl_ind(t1: int, tti: int, pdus: list[tuple[int, bytes]]) -> bytes:
    body = struct.pack("<III", t1, tti, len(pdus))
    for ptype, data in pdus:
        body += struct.pack("<IH", ptype, len(data)) + data
    return _pack(DL_IND, body)


def unpack_dl_ind(body: bytes):
    t1, tti, nof = struct.unpack_from("<III", body)
    off = 12
    pdus = []
    for _ in range(nof):
        ptype, ln = struct.unpack_from("<IH", body, off)
        off += 6
        pdus.append((ptype, body[off : off + ln]))
        off += ln
    return tti, pdus


def pack_ul_ind(t1: int, tti: int, rnti: int, ptype: int, length: int) -> bytes:
    return _pack(UL_IND, struct.pack("<IIIIH", t1, tti, rnti, ptype, length))


class _Udp:
    def __init__(self, bind_port: int, peer_port: int,
                 host: str = "127.0.0.1", timeout: float = 5.0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind((host, bind_port))
        self.sock.settimeout(timeout)
        self.peer = (host, peer_port)

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def send(self, msg: bytes):
        self.sock.sendto(msg, self.peer)

    def recv(self) -> tuple[int, bytes]:
        dgram, _ = self.sock.recvfrom(64 * 1024)
        return _unpack(dgram)

    def close(self):
        self.sock.close()


@dataclass
class GnbPnf:
    """gNB PHY side: announces slots, encodes TX.request TBs on device,
    decodes UL and reports RX_DATA_IND (basic_vnf.cc pnf_dummy + the real
    device compute of nr_worker.GnbNrWorker)."""

    worker: object  # nr_worker.GnbNrWorker
    link: _Udp
    slot_mod: int = 2  # distinct PHY slots (bounds the device-table cache)

    def run_slot(self, tti: int):
        """One slot: SF_IND -> (DL_CONFIG, TX.request) -> encoded grid."""
        tbs = self.worker.cfg.phy_grant(0).tbs
        self.link.send(pack_sf_ind(tti, tti, tbs // 8))
        grid = None
        while True:
            t, body = self.link.recv()
            if t == DL_CONFIG:
                continue  # beam id unused on the virtual RF
            if t == TX_REQUEST:
                req_tti, pdus = unpack_tx_request(body)
                assert req_tti == tti
                for ptype, data in pdus:
                    if ptype == PDSCH and data:
                        bits = np.unpackbits(
                            np.frombuffer(data, np.uint8))[: tbs]
                        self.worker.tx_data(bits)
                grid = self.worker.tx_slot(tti % self.slot_mod)
                return grid
            if t == SF_IND:
                raise RuntimeError("unexpected SF_IND echo")

    def report_ul(self, tb: bytes, sfn: int, slot: int):
        self.link.send(pack_rx_data_ind(0, sfn, slot, [(PUSCH, tb)]))


@dataclass
class GnbVnf:
    """gNB L2/L3 side: responds to SF_IND with DL_CONFIG + TX.request from
    the bearer queue; collects RX_DATA_IND (basic_vnf.cc vnf thread)."""

    link: _Udp
    tx_queue: list = field(default_factory=list)  # pending DL MAC TBs
    ul_data: list = field(default_factory=list)

    def handle_one(self):
        t, body = self.link.recv()
        if t == SF_IND:
            t1, tti, _ = struct.unpack_from("<III", body)
            self.link.send(pack_dl_config(t1, t1 + 1, tti, beam_id=0))
            pdus = []
            if self.tx_queue:
                pdus.append((PDSCH, self.tx_queue.pop(0)))
            self.link.send(pack_tx_request(tti, pdus))
        elif t == RX_DATA_IND:
            self.ul_data.append(unpack_rx_data_ind(body))
        return t


@dataclass
class UePnf:
    """UE PHY side: decodes DL slots on device and forwards the decoded
    TBs as DL_IND; announces UL grants with UL_IND (vnf_phy_nr.cc UE)."""

    worker: object  # nr_worker.UeNrWorker
    link: _Udp
    slot_mod: int = 2

    def run_slot(self, grid, tti: int):
        ul = self.worker.rx_slot(grid, tti % self.slot_mod)
        while self.worker.delivered:
            tb = self.worker.delivered.pop(0)
            data = np.packbits(np.asarray(tb, np.uint8)).tobytes()
            self.link.send(pack_dl_ind(tti, tti, [(PDSCH, data)]))
        return ul


@dataclass
class UeVnf:
    """UE L2/L3 side: consumes DL_IND PDUs into the stack rx path."""

    link: _Udp
    rx_tbs: list = field(default_factory=list)

    def handle_one(self):
        t, body = self.link.recv()
        if t == DL_IND:
            _, pdus = unpack_dl_ind(body)
            for ptype, data in pdus:
                if ptype == PDSCH:
                    self.rx_tbs.append(data)
        return t
