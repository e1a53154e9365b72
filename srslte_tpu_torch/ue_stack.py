"""UE NAS/USIM stack — attach client (srsue nas.cc + usim.cc equivalents).

Reference behavior: srsue/src/stack/upper/{nas.cc, usim.cc} — EMM attach
procedure with Milenage AKA on the soft-USIM, NAS security context
establishment, bearer bring-up from AttachAccept.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .nas.keys import kdf_kasme, kdf_nas_keys
from .nas.messages import (AttachAccept, AttachComplete, AttachRequest,
                           AuthRequest, AuthResponse, NasSecurityContext,
                           SecurityModeCommand, nas_pack, nas_unpack,
                           SecurityModeComplete)
from .security.milenage import milenage_f2345

DIR_UL = 0


@dataclass
class SoftUsim:
    imsi: str
    key: bytes
    opc: bytes

    def authenticate(self, rand: bytes, autn: bytes):
        """AKA: returns (res, ck, ik, sqn_xor_ak) after MAC check."""
        from .security.milenage import milenage_f1

        res, ck, ik, ak = milenage_f2345(self.key, self.opc, rand)
        sqn_xor_ak, amf, mac = autn[:6], autn[6:8], autn[8:]
        sqn = bytes(a ^ b for a, b in zip(sqn_xor_ak, ak))
        mac_a, _ = milenage_f1(self.key, self.opc, rand, sqn, amf)
        if mac_a != mac:
            raise ValueError("AUTN MAC failure (network not authenticated)")
        return res, ck, ik, sqn_xor_ak


@dataclass
class UeNas:
    usim: SoftUsim
    plmn: bytes = bytes.fromhex("00f110")
    state: str = "idle"
    sec: NasSecurityContext | None = None
    kasme: bytes = b""
    ip: str = ""
    guti: int = 0
    teid_ul: int = 0

    def start_attach(self) -> bytes:
        self.state = "attaching"
        return nas_pack(AttachRequest(imsi=self.usim.imsi))

    def rx_nas(self, raw: bytes) -> list:
        """Handle a downlink NAS PDU; returns uplink NAS PDUs."""
        from .nas.messages import (MT_SECURITY_MODE_COMMAND, PD_EMM,
                                   SEC_INTEGRITY_NEW_CTX)

        if (raw[0] >> 4) == SEC_INTEGRITY_NEW_CTX and self.sec is None:
            # SMC arrives integrity-protected with a context we don't have
            # yet: peek the plain inner message, derive keys, THEN verify.
            body = raw[6:]
            assert body[0] == PD_EMM and body[1] == MT_SECURITY_MODE_COMMAND
            peek = SecurityModeCommand.unpack_body(body)
            k_enc, k_int = kdf_nas_keys(self.kasme, peek.ea, peek.ia)
            self.sec = NasSecurityContext(k_enc, k_int, peek.ea, peek.ia,
                                          direction=DIR_UL)
        msg, protected = nas_unpack(raw, self.sec)
        if isinstance(msg, AuthRequest):
            res, ck, ik, sqn_xor_ak = self.usim.authenticate(msg.rand, msg.autn)
            self.kasme = kdf_kasme(ck, ik, self.plmn, sqn_xor_ak)
            return [nas_pack(AuthResponse(res=res))]
        if isinstance(msg, SecurityModeCommand):
            return [nas_pack(SecurityModeComplete(), self.sec)]
        if isinstance(msg, AttachAccept):
            assert protected
            self.state = "attached"
            self.ip, self.guti = msg.ip, msg.guti
            self.teid_ul = msg.teid_ul
            return [nas_pack(AttachComplete(), self.sec)]
        raise ValueError(f"unexpected NAS message {type(msg).__name__}")
