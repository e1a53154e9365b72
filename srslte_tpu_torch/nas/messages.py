"""NAS EMM message codec — a hand-written subset (24.301 §8/§9).

Reference behavior: lib/src/asn1/liblte_mme.cc (hand-written NAS pack/unpack)
used by srsue nas.cc and srsepc mme/nas.cc.  This covers the attach flow
message set with correct EMM framing (protocol discriminator, security
header type, message type, MAC + sequence number for protected messages);
the long tail of optional IEs is not implemented — each message carries the
mandatory IEs plus what the attach flow needs.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field

PD_EMM = 0x07
SEC_PLAIN = 0x0
SEC_INTEGRITY = 0x1
SEC_INTEGRITY_CIPHERED = 0x2
SEC_INTEGRITY_NEW_CTX = 0x3

SEC_SERVICE_REQUEST = 0xC  # 24.301 §9.3.1: security header type 1100

MT_ATTACH_REQUEST = 0x41
MT_ATTACH_ACCEPT = 0x42
MT_ATTACH_COMPLETE = 0x43
MT_TAU_REQUEST = 0x48
MT_TAU_ACCEPT = 0x49
MT_TAU_COMPLETE = 0x4A
MT_AUTH_REQUEST = 0x52
MT_AUTH_RESPONSE = 0x53
MT_SECURITY_MODE_COMMAND = 0x5D
MT_SECURITY_MODE_COMPLETE = 0x5E


@dataclass
class AttachRequest:
    imsi: str
    ue_caps: int = 0xF0  # EEA0-3/EIA1-3 supported bitmap (toy encoding)

    def pack_body(self) -> bytes:
        imsi_b = self.imsi.encode()
        return (bytes([PD_EMM, MT_ATTACH_REQUEST, len(imsi_b)]) + imsi_b
                + bytes([self.ue_caps]))

    @staticmethod
    def unpack_body(b: bytes) -> "AttachRequest":
        n = b[2]
        return AttachRequest(imsi=b[3 : 3 + n].decode(), ue_caps=b[3 + n])


@dataclass
class AuthRequest:
    rand: bytes
    autn: bytes

    def pack_body(self) -> bytes:
        return bytes([PD_EMM, MT_AUTH_REQUEST]) + self.rand + self.autn

    @staticmethod
    def unpack_body(b: bytes) -> "AuthRequest":
        return AuthRequest(rand=b[2:18], autn=b[18:34])


@dataclass
class AuthResponse:
    res: bytes

    def pack_body(self) -> bytes:
        return bytes([PD_EMM, MT_AUTH_RESPONSE, len(self.res)]) + self.res

    @staticmethod
    def unpack_body(b: bytes) -> "AuthResponse":
        return AuthResponse(res=b[3 : 3 + b[2]])


@dataclass
class SecurityModeCommand:
    ea: int
    ia: int

    def pack_body(self) -> bytes:
        return bytes([PD_EMM, MT_SECURITY_MODE_COMMAND, (self.ea << 4) | self.ia])

    @staticmethod
    def unpack_body(b: bytes) -> "SecurityModeCommand":
        return SecurityModeCommand(ea=b[2] >> 4, ia=b[2] & 0xF)


@dataclass
class SecurityModeComplete:
    def pack_body(self) -> bytes:
        return bytes([PD_EMM, MT_SECURITY_MODE_COMPLETE])

    @staticmethod
    def unpack_body(b: bytes) -> "SecurityModeComplete":
        return SecurityModeComplete()


@dataclass
class AttachAccept:
    guti: int
    ip: str
    teid_ul: int  # SPGW-side TEID the eNB sends UL traffic to

    def pack_body(self) -> bytes:
        ip_b = self.ip.encode()
        return (bytes([PD_EMM, MT_ATTACH_ACCEPT]) + struct.pack("!I", self.guti)
                + struct.pack("!I", self.teid_ul) + bytes([len(ip_b)]) + ip_b)

    @staticmethod
    def unpack_body(b: bytes) -> "AttachAccept":
        guti, teid = struct.unpack("!II", b[2:10])
        n = b[10]
        return AttachAccept(guti=guti, ip=b[11 : 11 + n].decode(), teid_ul=teid)


@dataclass
class AttachComplete:
    def pack_body(self) -> bytes:
        return bytes([PD_EMM, MT_ATTACH_COMPLETE])

    @staticmethod
    def unpack_body(b: bytes) -> "AttachComplete":
        return AttachComplete()


@dataclass
class TauRequest:
    """TRACKING AREA UPDATE REQUEST (24.301 §8.2.29): update type + GUTI."""

    update_type: int  # 0 = TA updating, 1 = combined, 2 = periodic
    guti: int

    def pack_body(self) -> bytes:
        return (bytes([PD_EMM, MT_TAU_REQUEST, self.update_type & 0x0F])
                + struct.pack("!I", self.guti))

    @staticmethod
    def unpack_body(b: bytes) -> "TauRequest":
        return TauRequest(update_type=b[2] & 0x0F,
                          guti=struct.unpack("!I", b[3:7])[0])


@dataclass
class TauAccept:
    """TRACKING AREA UPDATE ACCEPT: result + (optionally re-assigned) GUTI."""

    update_result: int = 0
    guti: int = 0  # 0 = GUTI unchanged
    tac: int = 0

    def pack_body(self) -> bytes:
        return (bytes([PD_EMM, MT_TAU_ACCEPT, self.update_result & 0x0F])
                + struct.pack("!IH", self.guti, self.tac))

    @staticmethod
    def unpack_body(b: bytes) -> "TauAccept":
        guti, tac = struct.unpack("!IH", b[3:9])
        return TauAccept(update_result=b[2] & 0x0F, guti=guti, tac=tac)


@dataclass
class TauComplete:
    def pack_body(self) -> bytes:
        return bytes([PD_EMM, MT_TAU_COMPLETE])

    @staticmethod
    def unpack_body(b: bytes) -> "TauComplete":
        return TauComplete()


@dataclass
class ServiceRequest:
    """SERVICE REQUEST (24.301 §8.2.25): the 4-byte short format.

    [ SHT=1100 | PD ] [ KSI(3) | seq(5) ] [ short MAC (2 bytes) ] — the
    short MAC is the low half of the EIA MAC over the first two bytes
    (liblte_mme.cc pack_service_request semantics).
    """

    ksi: int = 0
    seq: int = 0

    def pack(self, sec_ctx) -> bytes:
        from ..security import integrity_mac

        self.seq = sec_ctx.tx_count & 0x1F
        head = bytes([(SEC_SERVICE_REQUEST << 4) | PD_EMM,
                      ((self.ksi & 0x7) << 5) | self.seq])
        mac = integrity_mac(sec_ctx.ia, sec_ctx.k_int, sec_ctx.tx_count, 0,
                            sec_ctx.direction, head)
        sec_ctx.tx_count += 1
        return head + mac[2:4]

    @staticmethod
    def unpack(raw: bytes, sec_ctx) -> "ServiceRequest":
        from ..security import integrity_mac

        ksi, seq = raw[1] >> 5, raw[1] & 0x1F
        count = (sec_ctx.rx_count & ~0x1F) | seq
        calc = integrity_mac(sec_ctx.ia, sec_ctx.k_int, count, 0,
                             1 - sec_ctx.direction, raw[:2])
        if calc[2:4] != raw[2:4]:
            raise ValueError("service request short-MAC check failed")
        sec_ctx.rx_count = count + 1
        return ServiceRequest(ksi=ksi, seq=seq)


_BY_TYPE = {
    MT_ATTACH_REQUEST: AttachRequest,
    MT_ATTACH_ACCEPT: AttachAccept,
    MT_ATTACH_COMPLETE: AttachComplete,
    MT_AUTH_REQUEST: AuthRequest,
    MT_AUTH_RESPONSE: AuthResponse,
    MT_SECURITY_MODE_COMMAND: SecurityModeCommand,
    MT_SECURITY_MODE_COMPLETE: SecurityModeComplete,
    MT_TAU_REQUEST: TauRequest,
    MT_TAU_ACCEPT: TauAccept,
    MT_TAU_COMPLETE: TauComplete,
}


def nas_pack(msg, sec_ctx=None, new_ctx: bool = False) -> bytes:
    """Serialize; if sec_ctx given, wrap in a security-protected NAS message
    ([SHT|PD] MAC(4) SEQ(1) + (ciphered) plain message, 24.301 §9.1)."""
    body = msg.pack_body()
    if sec_ctx is None:
        return body
    from ..security import cipher_encrypt, integrity_mac

    seq = sec_ctx.tx_count & 0xFF
    sht = SEC_INTEGRITY_NEW_CTX if new_ctx else SEC_INTEGRITY_CIPHERED
    if not new_ctx:
        body = cipher_encrypt(sec_ctx.ea, sec_ctx.k_enc, sec_ctx.tx_count,
                              0, sec_ctx.direction, body)
    mac = integrity_mac(sec_ctx.ia, sec_ctx.k_int, sec_ctx.tx_count, 0,
                        sec_ctx.direction, bytes([seq]) + body)
    sec_ctx.tx_count += 1
    return bytes([(sht << 4) | PD_EMM]) + mac + bytes([seq]) + body


def nas_unpack(raw: bytes, sec_ctx=None):
    """Parse (verifying/deciphering when protected). Returns (msg, protected)."""
    sht = raw[0] >> 4
    if sht == SEC_PLAIN:
        return _BY_TYPE[raw[1]].unpack_body(raw), False
    if sht == SEC_SERVICE_REQUEST:
        return ServiceRequest.unpack(raw, sec_ctx), True
    from ..security import cipher_decrypt, integrity_mac

    assert sec_ctx is not None, "protected NAS message without context"
    mac, seq, body = raw[1:5], raw[5], raw[6:]
    count = (sec_ctx.rx_count & ~0xFF) | seq
    calc = integrity_mac(sec_ctx.ia, sec_ctx.k_int, count, 0,
                         1 - sec_ctx.direction, bytes([seq]) + body)
    if calc != mac:
        raise ValueError("NAS integrity check failed")
    if sht == SEC_INTEGRITY_CIPHERED:
        body = cipher_decrypt(sec_ctx.ea, sec_ctx.k_enc, count, 0,
                              1 - sec_ctx.direction, body)
    sec_ctx.rx_count = count + 1
    return _BY_TYPE[body[1]].unpack_body(body), True


@dataclass
class NasSecurityContext:
    """Per-UE NAS security context (one per direction pair)."""

    k_enc: bytes
    k_int: bytes
    ea: int
    ia: int
    direction: int  # 0 = this side sends uplink (UE), 1 = downlink (MME)
    tx_count: int = 0
    rx_count: int = 0
