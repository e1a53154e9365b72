"""PDCP entity (36.323, pdcp_entity_lte.cc equivalent).

Reference behavior: lib/src/upper/pdcp_entity_lte.cc — SN/COUNT management
(HFN || SN), integrity generate/verify on SRBs (:178), ciphering (:186),
in-order delivery (LTE PDCP relies on RLC AM ordering), integrity-failure
signalling.

SRB PDU: [RRR|SN(5)] hdr, SDU, MAC-I(4) — MAC over hdr||SDU with COUNT,
then SDU||MAC ciphered.  DRB PDU (12-bit SN): [D/C|RRR|SN(12)] 2-byte hdr,
ciphered SDU.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..security import EEA0, cipher_decrypt, cipher_encrypt, integrity_mac

DIR_UL, DIR_DL = 0, 1


@dataclass(frozen=True)
class PdcpConfig:
    is_srb: bool
    bearer_id: int  # 1-based (DRB-Identity / SRB id); BEARER = id - 1
    sn_len: int = 12  # DRBs: 7 or 12; SRBs always 5
    ea: int = EEA0  # ciphering algo
    ia: int = 0  # integrity algo (SRBs only; 0 = none)

    @property
    def sn_bits(self) -> int:
        return 5 if self.is_srb else self.sn_len

    @property
    def bearer(self) -> int:
        return self.bearer_id - 1


@dataclass
class PdcpEntity:
    cfg: PdcpConfig
    k_enc: bytes = bytes(16)
    k_int: bytes = bytes(16)
    is_ue: bool = True  # direction selection: UE tx = UL
    tx_count: int = 0
    rx_count: int = 0
    rx_sdus: list = field(default_factory=list)
    integrity_failed: int = 0

    @property
    def _sn_mod(self) -> int:
        return 1 << self.cfg.sn_bits

    def _tx_dir(self) -> int:
        return DIR_UL if self.is_ue else DIR_DL

    def _rx_dir(self) -> int:
        return DIR_DL if self.is_ue else DIR_UL

    def _header(self, sn: int) -> bytes:
        if self.cfg.is_srb:
            return bytes([sn & 0x1F])
        if self.cfg.sn_len == 12:
            return bytes([0x80 | ((sn >> 8) & 0xF), sn & 0xFF])
        return bytes([0x80 | (sn & 0x7F)])  # 7-bit SN data PDU

    # -- TX ---------------------------------------------------------------
    def tx(self, sdu: bytes) -> bytes:
        count = self.tx_count
        sn = count % self._sn_mod
        hdr = self._header(sn)
        direction = self._tx_dir()
        body = bytes(sdu)
        if self.cfg.is_srb and self.cfg.ia:
            mac = integrity_mac(self.cfg.ia, self.k_int, count,
                                self.cfg.bearer, direction, hdr + body)
            body = body + mac
        body = cipher_encrypt(self.cfg.ea, self.k_enc, count,
                              self.cfg.bearer, direction, body)
        self.tx_count += 1
        return hdr + body

    # -- RX ---------------------------------------------------------------
    def rx(self, pdu: bytes) -> bytes | None:
        if self.cfg.is_srb:
            sn = pdu[0] & 0x1F
            hdr, body = pdu[:1], pdu[1:]
        elif self.cfg.sn_len == 12:
            sn = ((pdu[0] & 0xF) << 8) | pdu[1]
            hdr, body = pdu[:2], pdu[2:]
        else:
            sn = pdu[0] & 0x7F
            hdr, body = pdu[:1], pdu[1:]
        # COUNT inference with HFN carry (36.323 §5.1.2 simplified in-order)
        exp = self.rx_count
        hfn = exp // self._sn_mod
        if sn < exp % self._sn_mod and (exp % self._sn_mod) - sn > self._sn_mod // 2:
            hfn += 1
        count = hfn * self._sn_mod + sn
        direction = self._rx_dir()
        body = cipher_decrypt(self.cfg.ea, self.k_enc, count,
                              self.cfg.bearer, direction, body)
        if self.cfg.is_srb and self.cfg.ia:
            if len(body) < 4:
                self.integrity_failed += 1
                return None
            sdu, mac = body[:-4], body[-4:]
            calc = integrity_mac(self.cfg.ia, self.k_int, count,
                                 self.cfg.bearer, direction, hdr + sdu)
            if calc != mac:
                self.integrity_failed += 1
                return None
        else:
            sdu = body
        self.rx_count = count + 1
        self.rx_sdus.append(sdu)
        return sdu
