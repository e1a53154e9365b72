"""NR PDCP entity (38.323, pdcp_entity_nr.cc equivalent).

Reference behavior: lib/src/upper/pdcp_entity_nr.cc — 12/18-bit SN with
COUNT = HFN||SN, data-PDU header (DRB: D/C + 3R + SN; SRB: 4R + SN),
ciphering over the payload and integrity (4-byte MAC-I) over header +
payload keyed by COUNT/bearer/direction, RX reordering window with the
COUNT inference rule of §5.2.2.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..security import cipher_decrypt, cipher_encrypt, integrity_mac

# NR NEA2/NIA2 are the AES-CTR/CMAC algorithms of LTE EEA2/EIA2 (38.331
# security: same primitives, NR-derived keys); algo id 2 in ciphers.py
_NEA2 = 2
_NIA2 = 2


@dataclass
class PdcpEntityNr:
    """One direction-agnostic entity (tx/rx methods)."""

    sn_bits: int = 12
    bearer: int = 1
    is_srb: bool = False
    k_enc: bytes | None = None
    k_int: bytes | None = None
    direction_tx: int = 1  # 1 = downlink sender semantics
    tx_next: int = 0
    rx_next: int = 0  # next expected COUNT
    rx_sdus: list = field(default_factory=list)
    integrity_failures: int = 0

    @property
    def _sn_mod(self) -> int:
        return 1 << self.sn_bits

    def _hdr(self, sn: int) -> bytes:
        if self.sn_bits == 12:
            b0 = (0x80 if not self.is_srb else 0x00) | ((sn >> 8) & 0x0F)
            return bytes([b0, sn & 0xFF])
        b0 = (0x80 if not self.is_srb else 0x00) | ((sn >> 16) & 0x03)
        return bytes([b0, (sn >> 8) & 0xFF, sn & 0xFF])

    def _parse_hdr(self, raw: bytes) -> tuple[int, bytes]:
        if self.sn_bits == 12:
            return ((raw[0] & 0x0F) << 8) | raw[1], raw[2:]
        return ((raw[0] & 0x03) << 16) | (raw[1] << 8) | raw[2], raw[3:]

    def tx(self, sdu: bytes) -> bytes:
        count = self.tx_next
        sn = count % self._sn_mod
        hdr = self._hdr(sn)
        body = sdu
        mac = b""
        if self.k_int is not None:
            mac = integrity_mac(_NIA2, self.k_int, count, self.bearer,
                                self.direction_tx, hdr + body)[:4]
        if self.k_enc is not None:
            body = cipher_encrypt(_NEA2, self.k_enc, count, self.bearer,
                                  self.direction_tx, body + mac)
            out = hdr + body
        else:
            out = hdr + body + mac
        self.tx_next += 1
        return out

    def _infer_count(self, sn: int) -> int:
        """38.323 §5.2.2: pick the COUNT with this SN closest to RX_NEXT."""
        win = self._sn_mod // 2
        hfn = self.rx_next // self._sn_mod
        base = self.rx_next % self._sn_mod
        if sn < base - win:
            hfn += 1
        elif sn >= base + win:
            hfn -= 1
        return max(hfn, 0) * self._sn_mod + sn

    def rx(self, pdu: bytes) -> bytes | None:
        sn, body = self._parse_hdr(pdu)
        count = self._infer_count(sn)
        if self.k_enc is not None:
            body = cipher_decrypt(_NEA2, self.k_enc, count, self.bearer,
                                  self.direction_tx, body)
        if self.k_int is not None:
            body, mac = body[:-4], body[-4:]
            want = integrity_mac(_NIA2, self.k_int, count, self.bearer,
                                 self.direction_tx, self._hdr(sn) + body)[:4]
            if mac != want:
                self.integrity_failures += 1
                return None
        if count >= self.rx_next:
            self.rx_next = count + 1
        self.rx_sdus.append(body)
        return body
