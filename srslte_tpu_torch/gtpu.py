"""GTP-U v1 codec (29.281, lib/src/upper/gtpu.cc equivalent).

Header: flags (version=1, PT=1), message type (0xFF = G-PDU, 1/2 = echo),
length, TEID; optional sequence number extension.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

MSG_ECHO_REQUEST = 1
MSG_ECHO_RESPONSE = 2
MSG_ERROR_INDICATION = 26
MSG_END_MARKER = 254
MSG_GPDU = 255


@dataclass
class GtpuHeader:
    teid: int
    msg_type: int = MSG_GPDU
    seq: int | None = None


def gtpu_pack(hdr: GtpuHeader, payload: bytes) -> bytes:
    flags = 0x30  # version 1, PT=1
    ext = b""
    if hdr.seq is not None:
        flags |= 0x02
        ext = struct.pack("!HBB", hdr.seq, 0, 0)
    length = len(payload) + len(ext)
    return struct.pack("!BBHI", flags, hdr.msg_type, length, hdr.teid) + ext + payload


def gtpu_unpack(raw: bytes) -> tuple[GtpuHeader, bytes]:
    flags, msg_type, length, teid = struct.unpack("!BBHI", raw[:8])
    if (flags >> 5) != 1:
        raise ValueError("not GTPv1")
    pos = 8
    seq = None
    if flags & 0x07:  # any of S/E/PN present: 4 more bytes
        seq = struct.unpack("!H", raw[8:10])[0] if flags & 0x02 else None
        pos = 12
    payload = raw[pos : 8 + length]
    return GtpuHeader(teid=teid, msg_type=msg_type, seq=seq), payload
