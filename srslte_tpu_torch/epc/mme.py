"""MME: per-UE EMM attach state machine (srsepc/src/mme/nas.cc equivalent).

Reference behavior: attach -> authentication (HSS vectors) -> security mode
(NAS integrity+ciphering on) -> create-session toward the SPGW -> attach
accept; states per UE context (mme/nas.cc:75).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..nas.keys import kdf_nas_keys
from ..nas.messages import (AttachAccept, AttachComplete, AttachRequest,
                            AuthRequest, AuthResponse, NasSecurityContext,
                            SecurityModeCommand, SecurityModeComplete,
                            nas_pack, nas_unpack)
from ..security import EEA2, EIA2
from .hss import Hss
from .spgw import Spgw

DIR_DL = 1


@dataclass
class UeContext:
    imsi: str = ""
    state: str = "idle"
    xres: bytes = b""
    kasme: bytes = b""
    sec: NasSecurityContext | None = None
    guti: int = 0
    teid_dl: int = 0


@dataclass
class Mme:
    hss: Hss
    spgw: Spgw
    ea: int = EEA2
    ia: int = EIA2
    next_guti: int = 0x1000
    ues: dict = field(default_factory=dict)  # ue_id -> UeContext

    def _create_session(self, ctx: UeContext) -> tuple[str, int]:
        """Default bearer toward the SPGW; overridden by the wire MME to
        run GTP-C over the S11 socket (mme_gtpc.cc:send_create_session_
        request)."""
        tun = self.spgw.create_session(ctx.imsi, ctx.teid_dl)
        return tun.ue_ip, tun.teid_ul

    def rx_nas(self, ue_id: int, raw: bytes) -> list:
        """Handle an uplink NAS PDU; returns downlink NAS PDUs to send."""
        ctx = self.ues.setdefault(ue_id, UeContext())
        msg, protected = nas_unpack(raw, ctx.sec)
        if isinstance(msg, AttachRequest):
            ctx.imsi = msg.imsi
            ctx.state = "auth"
            vec = self.hss.auth_vector(msg.imsi)
            if vec is None:
                return []  # attach reject path (unknown IMSI)
            rand, xres, autn, kasme = vec
            ctx.xres, ctx.kasme = xres, kasme
            return [nas_pack(AuthRequest(rand=rand, autn=autn))]
        if isinstance(msg, AuthResponse):
            if ctx.state != "auth" or msg.res != ctx.xres:
                ctx.state = "idle"
                return []
            ctx.state = "smc"
            k_enc, k_int = kdf_nas_keys(ctx.kasme, self.ea, self.ia)
            ctx.sec = NasSecurityContext(k_enc, k_int, self.ea, self.ia,
                                         direction=DIR_DL)
            return [nas_pack(SecurityModeCommand(self.ea, self.ia), ctx.sec,
                             new_ctx=True)]
        if isinstance(msg, SecurityModeComplete):
            assert protected, "SMC complete must be integrity protected"
            ctx.state = "attached"
            ctx.guti = self.next_guti
            self.next_guti += 1
            ctx.teid_dl = ue_id + 0x100  # eNB-side TEID (S1AP would carry it)
            ue_ip, teid_ul = self._create_session(ctx)
            return [nas_pack(AttachAccept(guti=ctx.guti, ip=ue_ip,
                                          teid_ul=teid_ul), ctx.sec)]
        if isinstance(msg, AttachComplete):
            return []
        raise ValueError(f"unexpected NAS message {type(msg).__name__}")
