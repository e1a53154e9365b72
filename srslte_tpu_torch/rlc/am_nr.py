"""NR RLC AM PDU codecs (38.322, rlc_am_nr.cc equivalent).

Reference behavior: lib/src/upper/rlc_am_nr.cc — the 21.04 snapshot ships
the NR AM *codecs* only (no AM entity yet): data PDU header with D/C, P,
SI, 12/18-bit SN and 16-bit SO on non-first segments
(rlc_am_nr_read/write_data_pdu_header :39/:109), and the 12-bit-SN status
PDU with ACK_SN and E1-chained NACK_SN (read :155 / write :216).  Byte
vectors from lib/test/upper/rlc_am_nr_pdu_test.cc are the oracles.

One deliberate divergence: the reference's status writer emits
``nack_sn & 0xF0`` for the trailing half-byte (rlc_am_nr.cc:243), which
its own reader decodes as ``(byte >> 4)`` — the two only agree when
bit 4 of nack_sn is clear (true of the committed vector, 273).  We pack
the 38.322 layout ``(nack_sn & 0xF) << 4`` that the reader (and the
committed vectors) define.
"""

from __future__ import annotations

from dataclasses import dataclass, field

SI_FULL, SI_FIRST, SI_LAST, SI_MID = 0, 1, 2, 3
CPT_STATUS = 0


@dataclass(frozen=True)
class AmNrHeader:
    """NR AM data PDU header fields."""

    sn: int
    si: int = SI_FULL
    p: int = 0
    so: int = 0  # segment offset; present iff si in (SI_LAST, SI_MID)
    dc: int = 1  # data PDU


def pack_am_nr(h: AmNrHeader, payload: bytes = b"",
               sn_bits: int = 12) -> bytes:
    hdr = bytearray([(h.dc & 1) << 7 | (h.p & 1) << 6 | (h.si & 3) << 4])
    if sn_bits == 12:
        hdr[0] |= (h.sn >> 8) & 0x0F
        hdr.append(h.sn & 0xFF)
    elif sn_bits == 18:
        hdr[0] |= (h.sn >> 16) & 0x03
        hdr += bytes([(h.sn >> 8) & 0xFF, h.sn & 0xFF])
    else:
        raise ValueError(f"unsupported SN size {sn_bits}")
    if h.si in (SI_LAST, SI_MID):
        hdr += bytes([(h.so >> 8) & 0xFF, h.so & 0xFF])
    return bytes(hdr) + payload


def unpack_am_nr(raw: bytes, sn_bits: int = 12):
    """-> (AmNrHeader, payload) or None on a malformed header
    (reserved bits set, like the reference's 0-return)."""
    dc = (raw[0] >> 7) & 1
    p = (raw[0] >> 6) & 1
    si = (raw[0] >> 4) & 3
    if sn_bits == 12:
        sn = ((raw[0] & 0x0F) << 8) | raw[1]
        pos = 2
    elif sn_bits == 18:
        if raw[0] & 0x0C:
            return None  # reserved bits set
        sn = ((raw[0] & 0x03) << 16) | (raw[1] << 8) | raw[2]
        pos = 3
    else:
        raise ValueError(f"unsupported SN size {sn_bits}")
    so = 0
    if si in (SI_LAST, SI_MID):
        so = (raw[pos] << 8) | raw[pos + 1]
        pos += 2
    return AmNrHeader(sn=sn, si=si, p=p, so=so, dc=dc), raw[pos:]


def is_control_pdu(raw: bytes) -> bool:
    """D/C bit clear = control PDU (rlc_am_is_control_pdu)."""
    return (raw[0] >> 7) & 1 == 0


@dataclass
class AmNrStatus:
    """NR AM status PDU: cumulative ACK_SN + individual NACK_SNs."""

    ack_sn: int
    nacks: list = field(default_factory=list)


def pack_am_nr_status(s: AmNrStatus, sn_bits: int = 12) -> bytes:
    if sn_bits == 12:
        # ACK_SN(12) | E1(1)+reserved(7) | per nack: NACK_SN(12) +
        # E1,E2,E3,reserved(4) (38.322 §6.2.2.5)
        out = bytearray([(s.ack_sn >> 8) & 0x0F, s.ack_sn & 0xFF,
                         0x80 if s.nacks else 0x00])
        for i, nack in enumerate(s.nacks):
            e1 = 0x08 if i + 1 < len(s.nacks) else 0
            out += bytes([(nack >> 4) & 0xFF, ((nack & 0x0F) << 4) | e1])
        return bytes(out)
    if sn_bits == 18:
        return bytes([(s.ack_sn >> 14) & 0x0F, (s.ack_sn >> 8) & 0x3F | 0,
                      s.ack_sn & 0xFF, 0x00])
    raise ValueError(f"unsupported SN size {sn_bits}")


def unpack_am_nr_status(raw: bytes, sn_bits: int = 12):
    """-> AmNrStatus or None on malformed input."""
    cpt = (raw[0] >> 4) & 0x07
    if (raw[0] >> 7) & 1 or cpt != CPT_STATUS:
        return None
    if sn_bits != 12:
        raise ValueError(f"unsupported SN size {sn_bits}")
    ack = ((raw[0] & 0x0F) << 8) | raw[1]
    s = AmNrStatus(ack_sn=ack)
    pos = 2
    e1 = raw[pos] & 0x80
    if raw[pos] & 0x7F:
        return None  # reserved bits set
    pos += 1
    while e1:
        nack = (raw[pos] << 4) | ((raw[pos + 1] & 0xF0) >> 4)
        s.nacks.append(nack)
        e1 = raw[pos + 1] & 0x08  # E1 of this nack's flag half-byte
        pos += 2
    return s
