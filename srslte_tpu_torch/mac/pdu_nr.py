"""NR MAC PDU pack/unpack (38.321 §6.1.2, mac_sch_pdu_nr.cc equivalent).

Reference behavior: lib/src/mac/mac_sch_pdu_nr.cc — subPDU = R|F|LCID(6)
subheader + 8/16-bit L (F selects) + payload; fixed-size CEs carry no L;
DL-SCH places CEs first, UL-SCH places them last; padding (LCID 63)
absorbs the tail.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# LCID values (38.321 tables 6.2.1-1/2)
LCID_CCCH = 0
LCID_PAD = 63
LCID_SHORT_BSR = 61  # UL
LCID_C_RNTI = 58  # UL
LCID_CON_RES = 62  # DL, 6-byte UE contention resolution identity
LCID_TA_CMD = 61  # DL timing advance command (1 byte)

_FIXED_CE_LEN_UL = {LCID_SHORT_BSR: 1, LCID_C_RNTI: 2}
_FIXED_CE_LEN_DL = {LCID_CON_RES: 6, LCID_TA_CMD: 1}


@dataclass
class MacPduNr:
    """Assemble/parse one NR MAC PDU."""

    is_ul: bool = False
    subpdus: list = field(default_factory=list)  # (lcid, payload)

    def add_sdu(self, lcid: int, sdu: bytes):
        assert 0 <= lcid <= 32
        self.subpdus.append((lcid, sdu))

    def add_ce(self, lcid: int, payload: bytes):
        fixed = _FIXED_CE_LEN_UL if self.is_ul else _FIXED_CE_LEN_DL
        assert lcid in fixed and len(payload) == fixed[lcid]
        self.subpdus.append((lcid, payload))

    @staticmethod
    def _subheader(lcid: int, length: int | None) -> bytes:
        if length is None:
            return bytes([lcid & 0x3F])  # fixed-size CE / padding: no L
        if length < 256:
            return bytes([lcid & 0x3F, length])
        return bytes([0x40 | (lcid & 0x3F), (length >> 8) & 0xFF,
                      length & 0xFF])

    def pack(self, tb_size: int | None = None) -> bytes:
        fixed = _FIXED_CE_LEN_UL if self.is_ul else _FIXED_CE_LEN_DL
        ces = [(l, p) for l, p in self.subpdus if l in fixed]
        sdus = [(l, p) for l, p in self.subpdus if l not in fixed]
        # DL: CEs before SDUs; UL: CEs after SDUs (38.321 §6.1.2)
        ordered = (sdus + ces) if self.is_ul else (ces + sdus)
        out = bytearray()
        for lcid, p in ordered:
            if lcid in fixed:
                out += self._subheader(lcid, None) + p
            else:
                out += self._subheader(lcid, len(p)) + p
        if tb_size is not None:
            if len(out) + 1 <= tb_size:
                out += self._subheader(LCID_PAD, None)
                out += bytes(tb_size - len(out))
            assert len(out) <= tb_size, "PDU exceeds TB"
        return bytes(out)

    @classmethod
    def unpack(cls, raw: bytes, is_ul: bool = False) -> "MacPduNr":
        fixed = _FIXED_CE_LEN_UL if is_ul else _FIXED_CE_LEN_DL
        pdu = cls(is_ul=is_ul)
        pos = 0
        while pos < len(raw):
            b0 = raw[pos]
            lcid = b0 & 0x3F
            f = (b0 >> 6) & 1
            pos += 1
            if lcid == LCID_PAD:
                break  # padding absorbs the rest
            if lcid in fixed:
                ln = fixed[lcid]
            elif f:
                ln = (raw[pos] << 8) | raw[pos + 1]
                pos += 2
            else:
                ln = raw[pos]
                pos += 1
            pdu.subpdus.append((lcid, raw[pos : pos + ln]))
            pos += ln
        return pdu

    def sdus(self, lcid: int | None = None) -> list:
        fixed = _FIXED_CE_LEN_UL if self.is_ul else _FIXED_CE_LEN_DL
        return [p for l, p in self.subpdus
                if l not in fixed and (lcid is None or l == lcid)]

    def ces(self) -> list:
        fixed = _FIXED_CE_LEN_UL if self.is_ul else _FIXED_CE_LEN_DL
        return [(l, p) for l, p in self.subpdus if l in fixed]
