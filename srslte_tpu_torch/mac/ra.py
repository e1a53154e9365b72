"""Random-access procedure, msg1-4 (36.321 §5.1).

Reference behavior: srsue/src/stack/mac/proc_ra.cc (UE FSM: preamble ->
RAR window -> msg3 with C-RNTI/CCCH SDU -> contention resolution) and
srsenb mac::rach_detected + RAR scheduling (srsenb/src/stack/mac/mac.cc).

PHY coupling: preamble selection/transmission uses phy/phch/prach.py; this
module is the MAC-side state machine and PDU plumbing (RarPdu from pdu.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .pdu import DL_LCID, MacPdu, Rar, RarPdu, UL_LCID


@dataclass
class UeRaProc:
    """UE-side RA FSM. Drive with tick(); poll .state."""

    ra_rnti_base: int = 1
    rar_window: int = 10  # TTIs
    max_attempts: int = 8
    state: str = "idle"
    preamble: int = -1
    attempt: int = 0
    temp_crnti: int = 0
    crnti: int = 0
    ta: int = 0
    _win: int = 0
    _con_res_id: bytes = b""

    def start(self, rng=None) -> int:
        """-> preamble index to transmit on PRACH (msg1)."""
        rng = rng or np.random.default_rng()
        self.preamble = int(rng.integers(0, 64))
        self.attempt += 1
        self.state = "wait_rar"
        self._win = 0
        return self.preamble

    def start_dedicated(self, preamble: int) -> int:
        """Contention-free RA with a dedicated preamble (handover,
        36.321 5.1.2): no contention resolution follows the RAR."""
        self.preamble = int(preamble)
        self.attempt += 1
        self.state = "wait_rar"
        self._win = 0
        return self.preamble

    def rx_rar_dedicated(self, raw: bytes):
        """CFRA RAR: -> (temp_crnti, ta) and done, or None."""
        if self.state != "wait_rar":
            return None
        rar = RarPdu.parse(raw)
        for r in rar.rars:
            if r.rapid == self.preamble:
                self.temp_crnti = self.crnti = r.temp_crnti
                self.ta = r.ta
                self.state = "connected"
                return (r.temp_crnti, r.ta)
        return None

    def tick(self):
        if self.state == "wait_rar":
            self._win += 1
            if self._win > self.rar_window:
                self.state = "idle" if self.attempt < self.max_attempts else "failed"

    def rx_rar(self, raw: bytes, ccch_sdu: bytes | None = None) -> MacPdu | None:
        """Process a RAR PDU; if our RAPID is present, returns msg3.

        ccch_sdu: the RRCConnectionRequest to carry (its first 6 bytes act
        as the contention-resolution identity, 36.321 §5.1.5); a random
        48-bit identity is generated when omitted.
        """
        if self.state != "wait_rar":
            return None
        rar = RarPdu.parse(raw)
        for r in rar.rars:
            if r.rapid == self.preamble:
                self.temp_crnti = r.temp_crnti
                self.ta = r.ta
                self.state = "wait_conres"
                self._win = 0
                import os

                sdu = ccch_sdu if ccch_sdu is not None else os.urandom(6)
                self._con_res_id = sdu[:6].ljust(6, b"\0")
                msg3 = MacPdu(ul=True)
                msg3.add_sdu(int(UL_LCID.CCCH), sdu)
                return msg3
        return None

    def rx_msg4(self, raw: bytes) -> bool:
        """Contention resolution: match the UE-identity CE (msg4)."""
        if self.state != "wait_conres":
            return False
        pdu = MacPdu.parse(raw)
        for s in pdu.subpdus:
            if s.lcid == int(DL_LCID.CON_RES_ID):
                if s.payload == self._con_res_id:
                    self.crnti = self.temp_crnti
                    self.state = "connected"
                    return True
                self.state = "idle"  # lost contention
        return False


@dataclass
class EnbRach:
    """eNB-side RACH handling: detected preambles -> RAR; msg3 -> msg4."""

    next_crnti: int = 0x46
    pending: dict = field(default_factory=dict)  # temp_crnti -> ta
    reserved: dict = field(default_factory=dict)  # preamble -> crnti (CFRA)
    last_rar_crnti: int = 0  # C-RNTI of the most recent RAR (msg3 owner)

    def reserve(self, preamble: int, crnti: int):
        """Dedicated (contention-free) preamble for handover RACH
        (36.321 5.1.1 ra-PreambleIndex via mobilityControlInfo)."""
        self.reserved[preamble] = crnti

    def rach_detected(self, preambles: list, tas: list) -> bytes:
        """Build the RAR PDU for this TTI's detected preambles."""
        rar = RarPdu(backoff=None)
        for p, ta in zip(preambles, tas):
            if int(p) in self.reserved:
                # contention-free: temp C-RNTI is the pre-assigned C-RNTI
                # and no contention resolution follows
                crnti = self.reserved.pop(int(p))
            else:
                crnti = self.next_crnti
                self.next_crnti += 1
                self.pending[crnti] = ta
            rar.rars.append(Rar(rapid=int(p), ta=int(ta), grant=0x1234,
                                temp_crnti=crnti))
            self.last_rar_crnti = crnti
        return rar.pack()

    def rx_msg3(self, temp_crnti: int, raw: bytes) -> bytes | None:
        """msg3 CCCH SDU -> msg4 with the contention-resolution CE."""
        if temp_crnti not in self.pending:
            return None
        pdu = MacPdu.parse(raw, ul=True)
        ccch = next((s for s in pdu.subpdus if s.lcid == int(UL_LCID.CCCH)),
                    None)
        if ccch is None:
            return None
        msg4 = MacPdu()
        msg4.add_ce(int(DL_LCID.CON_RES_ID), ccch.payload[:6])
        del self.pending[temp_crnti]
        return msg4.pack()
