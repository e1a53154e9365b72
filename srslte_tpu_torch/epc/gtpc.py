"""GTP-C v2 S11 messages between MME and SPGW (29.274 subset).

Reference behavior: lib/include/srsran/asn1/gtpc.h + srsepc/src/mme/
mme_gtpc.cc:1-487 and srsepc/src/spgw/gtpc.cc — the reference serializes
in-memory `gtpc_pdu` C structs straight onto a datagram socket between the
MME and SPGW (`sendto(m_s11, &pdu, sizeof(pdu))`), i.e. struct-level (not
full 29.274 TLV) wire format.  This module mirrors that: dataclass PDUs
with a deterministic `struct` serialization, carried over UDP.

Header fields per gtpc_header_t: version(=2), type, teid, sequence.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

GTPC_VERSION = 2

CREATE_SESSION_REQUEST = 32
CREATE_SESSION_RESPONSE = 33
MODIFY_BEARER_REQUEST = 34
MODIFY_BEARER_RESPONSE = 35
DELETE_SESSION_REQUEST = 36
DELETE_SESSION_RESPONSE = 37
RELEASE_ACCESS_BEARERS_REQUEST = 170
RELEASE_ACCESS_BEARERS_RESPONSE = 171
DOWNLINK_DATA_NOTIFICATION = 176
DOWNLINK_DATA_NOTIFICATION_ACK = 177

_HDR = struct.Struct("!BBQQ")  # version, type, teid, sequence


@dataclass
class Fteid:
    """F-TEID IE: TEID + IPv4 (29.274 8.22, gtpc_ies.h gtpc_f_teid_ie).

    Carries a UDP port too: the standard pins GTP-U to 2152, but tests
    bind ephemeral ports; struct-level GTP-C (like the reference's
    in-memory PDUs) can simply carry it."""

    teid: int
    ipv4: str
    port: int = 2152

    SIZE = 10

    def pack(self) -> bytes:
        return struct.pack("!I4BH", self.teid,
                           *(int(x) for x in self.ipv4.split(".")),
                           self.port)

    @classmethod
    def unpack(cls, raw: bytes) -> "Fteid":
        teid, a, b, c, d, port = struct.unpack("!I4BH", raw[:10])
        return cls(teid, f"{a}.{b}.{c}.{d}", port)


@dataclass
class GtpcPdu:
    msg_type: int
    teid: int = 0
    sequence: int = 0
    imsi: int = 0
    mme_ctrl_teid: int = 0       # sender control-plane TEID
    cause: int = 16              # 16 = accepted (29.274 8.4)
    ebi: int = 5                 # EPS bearer id
    user_fteid: Fteid | None = None  # S1-U F-TEID (direction per msg type)
    paa: str = ""                # PDN address allocation (UE IP)

    def pack(self) -> bytes:
        out = [_HDR.pack(GTPC_VERSION, self.msg_type, self.teid,
                         self.sequence)]
        out.append(struct.pack("!QQBB", self.imsi, self.mme_ctrl_teid,
                               self.cause, self.ebi))
        if self.user_fteid is not None:
            out.append(b"\x01" + self.user_fteid.pack())
        else:
            out.append(b"\x00")
        paa = self.paa.encode()
        out.append(struct.pack("!B", len(paa)) + paa)
        return b"".join(out)

    @classmethod
    def unpack(cls, raw: bytes) -> "GtpcPdu":
        version, msg_type, teid, seq = _HDR.unpack(raw[:18])
        if version != GTPC_VERSION:
            raise ValueError("not GTP-C v2")
        imsi, ctrl, cause, ebi = struct.unpack("!QQBB", raw[18:36])
        pos = 36
        fteid = None
        if raw[pos]:
            fteid = Fteid.unpack(raw[pos + 1 : pos + 1 + Fteid.SIZE])
            pos += 1 + Fteid.SIZE
        else:
            pos += 1
        n = raw[pos]
        paa = raw[pos + 1 : pos + 1 + n].decode()
        return cls(msg_type, teid, seq, imsi, ctrl, cause, ebi, fteid, paa)
