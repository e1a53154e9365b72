"""LTE MAC PDU pack/parse (36.321 §6), lib/src/mac/pdu.cc equivalent.

Reference behavior: lib/src/mac/pdu.cc (sch_pdu/rar_pdu pack+parse, 1,188
LoC): R/R/E/LCID subheaders with 7/15-bit length fields, control elements
(BSR, PHR, C-RNTI, contention resolution, timing advance), RAR PDUs with
BI/RAPID headers and 6-byte grants.

Host-side byte twiddling (control plane); payloads stay numpy uint8.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np


class DL_LCID(enum.IntEnum):
    CCCH = 0
    CON_RES_ID = 28
    TA_CMD = 29
    DRX_CMD = 30
    PADDING = 31


class UL_LCID(enum.IntEnum):
    CCCH = 0
    CRNTI = 27
    TRUNC_BSR = 28
    SHORT_BSR = 29
    LONG_BSR = 30
    PADDING = 31


# fixed control-element sizes in bytes (0 = no payload)
_CE_SIZE_DL = {DL_LCID.CON_RES_ID: 6, DL_LCID.TA_CMD: 1, DL_LCID.DRX_CMD: 0,
               DL_LCID.PADDING: 0}
_CE_SIZE_UL = {UL_LCID.CRNTI: 2, UL_LCID.TRUNC_BSR: 1, UL_LCID.SHORT_BSR: 1,
               UL_LCID.LONG_BSR: 3, UL_LCID.PADDING: 0}


@dataclass
class MacSubPdu:
    lcid: int
    payload: bytes = b""

    @property
    def is_sdu(self) -> bool:
        return 0 <= self.lcid <= 10


@dataclass
class MacPdu:
    """A DL-SCH or UL-SCH MAC PDU."""

    subpdus: list = field(default_factory=list)
    ul: bool = False

    def add_sdu(self, lcid: int, data: bytes):
        assert 0 <= lcid <= 10
        self.subpdus.append(MacSubPdu(lcid, bytes(data)))

    def add_ce(self, lcid: int, payload: bytes = b""):
        size = (_CE_SIZE_UL if self.ul else _CE_SIZE_DL)[lcid]
        assert len(payload) == size, (lcid, len(payload), size)
        self.subpdus.append(MacSubPdu(int(lcid), bytes(payload)))

    # -- pack -----------------------------------------------------------------
    def pack(self, pdu_len: int | None = None) -> bytes:
        """Serialize; pads with PADDING LCID to pdu_len if given (§6.1.2)."""
        subs = list(self.subpdus)
        ces = [s for s in subs if not s.is_sdu]
        sdus = [s for s in subs if s.is_sdu]
        # CEs first, then SDUs (36.321 §6.1.2 ordering)
        ordered = ces + sdus
        hdr = bytearray()
        body = bytearray()
        pad_lcid = int(UL_LCID.PADDING)
        # compute headers; every subheader except the last of variable size
        # carries F/L; CEs never carry length fields
        for i, s in enumerate(ordered):
            last = i == len(ordered) - 1
            e = 0 if last else 1
            if s.is_sdu and not last:
                l = len(s.payload)
                if l < 128:
                    hdr.append((e << 5) | s.lcid)
                    hdr.append(l & 0x7F)  # F=0, 7-bit length
                else:
                    hdr.append((e << 5) | s.lcid)
                    hdr.append(0x80 | (l >> 8))  # F=1 + length high
                    hdr.append(l & 0xFF)
            else:
                hdr.append((e << 5) | s.lcid)
            body.extend(s.payload)
        out = bytes(hdr) + bytes(body)
        if pdu_len is not None:
            if len(out) > pdu_len:
                raise ValueError(f"PDU {len(out)} exceeds {pdu_len}")
            n_pad = pdu_len - len(out)
            if n_pad == 1:
                # single padding subheader in front (E=1: more headers follow)
                out = bytes([(1 << 5) | pad_lcid]) + out
            elif n_pad >= 2:
                # re-pack with a trailing padding subheader chain:
                # simplest valid form: two leading padding subheaders... use
                # one padding subheader at the END with implicit length
                hdr2 = bytearray()
                for i, s in enumerate(ordered):
                    if s.is_sdu:
                        l = len(s.payload)
                        if l < 128:
                            hdr2.append((1 << 5) | s.lcid)
                            hdr2.append(l & 0x7F)
                        else:
                            hdr2.append((1 << 5) | s.lcid)
                            hdr2.append(0x80 | (l >> 8))
                            hdr2.append(l & 0xFF)
                    else:
                        hdr2.append((1 << 5) | s.lcid)
                out = bytes(hdr2) + bytes([pad_lcid]) + bytes(body)
                out = out + bytes(pdu_len - len(out))
            # n_pad == 0: exact fit
        return out

    # -- parse ----------------------------------------------------------------
    @staticmethod
    def parse(raw: bytes, ul: bool = False) -> "MacPdu":
        ce_sizes = _CE_SIZE_UL if ul else _CE_SIZE_DL
        pdu = MacPdu(ul=ul)
        pos = 0
        heads = []  # (lcid, explicit_len or None)
        while True:
            b = raw[pos]
            pos += 1
            e = (b >> 5) & 1
            lcid = b & 0x1F
            if 0 <= lcid <= 10 and e:
                f = raw[pos] >> 7
                if f:
                    ln = ((raw[pos] & 0x7F) << 8) | raw[pos + 1]
                    pos += 2
                else:
                    ln = raw[pos] & 0x7F
                    pos += 1
                heads.append((lcid, ln))
            else:
                heads.append((lcid, None))
            if not e:
                break
        for i, (lcid, ln) in enumerate(heads):
            if lcid == int(UL_LCID.PADDING):
                continue
            if 0 <= lcid <= 10:
                n = ln if ln is not None else len(raw) - pos
                payload = raw[pos : pos + n]
                pos += n
            else:
                n = ce_sizes.get(lcid, 0)
                payload = raw[pos : pos + n]
                pos += n
            pdu.subpdus.append(MacSubPdu(lcid, bytes(payload)))
        return pdu


# ----------------------------------------------------------------- RAR PDU
@dataclass
class Rar:
    rapid: int
    ta: int  # 11-bit timing advance
    grant: int  # 20-bit UL grant
    temp_crnti: int


@dataclass
class RarPdu:
    """Random access response PDU (36.321 §6.1.5/§6.2.2/§6.2.3)."""

    backoff: int | None = None
    rars: list = field(default_factory=list)

    def pack(self) -> bytes:
        out = bytearray()
        heads = []
        if self.backoff is not None:
            heads.append(("bi", self.backoff))
        for r in self.rars:
            heads.append(("rapid", r.rapid))
        for i, (kind, val) in enumerate(heads):
            e = 0 if i == len(heads) - 1 else 1
            t = 1 if kind == "rapid" else 0
            out.append((e << 7) | (t << 6) | (val & 0x3F))
        for r in self.rars:
            body = (r.ta << 36) | (r.grant << 16) | r.temp_crnti
            out.extend(body.to_bytes(6, "big"))
        return bytes(out)

    @staticmethod
    def parse(raw: bytes) -> "RarPdu":
        pdu = RarPdu()
        pos = 0
        rapids = []
        while True:
            b = raw[pos]
            pos += 1
            e, t, v = (b >> 7) & 1, (b >> 6) & 1, b & 0x3F
            if t:
                rapids.append(v)
            else:
                pdu.backoff = v & 0xF
            if not e:
                break
        for rapid in rapids:
            body = int.from_bytes(raw[pos : pos + 6], "big")
            pos += 6
            pdu.rars.append(Rar(rapid=rapid, ta=(body >> 36) & 0x7FF,
                                grant=(body >> 16) & 0xFFFFF,
                                temp_crnti=body & 0xFFFF))
        return pdu
