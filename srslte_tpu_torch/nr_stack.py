"""NR data-plane stack: PDCP-NR / RLC-UM-NR / MAC-NR over the slot workers.

Reference behavior: srsenb/src/stack/gnb_stack_nr.cc and
srsue/src/stack/ue_stack_nr.cc — the L2 glue that muxes bearer SDUs through
PDCP (security, COUNT), RLC UM (segmentation/reassembly) and the MAC PDU
codec (mac_sch_pdu_nr.cc) into the transport blocks the PHY workers carry;
srsue/src/stack/mac_nr/{mux_nr.cc, demux_nr.cc} for the MAC mux/demux.

L2 runs on the host on bytes (no per-PDU device work); the PHY boundary is
the worker's queue of TB bit arrays, which the workers move to and from
their device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .mac.pdu_nr import MacPduNr
from .nr_worker import GnbNrWorker, UeNrWorker
from .pdcp.entity_nr import PdcpEntityNr
from .rlc.um_nr import RlcUmNr

LCID_DRB = 4  # first DRB (gnb_stack_nr.cc bearer setup)


def _tb_bits(raw: bytes, tbs: int) -> np.ndarray:
    bits = np.unpackbits(np.frombuffer(raw, np.uint8))
    assert len(bits) <= tbs
    return np.pad(bits, (0, tbs - len(bits)))


@dataclass
class GnbNrStack:
    """DL sender: packets -> PDCP -> RLC UM -> MAC PDU -> worker TB queue."""

    worker: GnbNrWorker
    k_enc: bytes | None = None
    pdcp: PdcpEntityNr = None
    rlc: RlcUmNr = field(default_factory=RlcUmNr)

    def __post_init__(self):
        if self.pdcp is None:
            self.pdcp = PdcpEntityNr(bearer=1, k_enc=self.k_enc,
                                     direction_tx=1)

    @property
    def _tbs(self) -> int:
        return self.worker.cfg.phy_grant(0).tbs

    def send_packet(self, pkt: bytes):
        self.rlc.write_sdu(self.pdcp.tx(pkt))

    def pump_tx(self):
        """Drain RLC into MAC TBs queued at the PHY worker (mux_nr.cc)."""
        tb_bytes = self._tbs // 8
        while self.rlc.get_buffer_state() > 0:
            payload = self.rlc.read_pdu(tb_bytes - 3)  # subheader margin
            if payload is None:
                break
            pdu = MacPduNr(is_ul=False)
            pdu.add_sdu(LCID_DRB, payload)
            self.worker.tx_data(_tb_bits(pdu.pack(tb_size=tb_bytes),
                                         self._tbs))


@dataclass
class UeNrStack:
    """DL receiver: worker TBs -> MAC demux -> RLC UM -> PDCP -> packets."""

    worker: UeNrWorker
    k_enc: bytes | None = None
    pdcp: PdcpEntityNr = None
    rlc: RlcUmNr = field(default_factory=RlcUmNr)
    received: list = field(default_factory=list)

    def __post_init__(self):
        if self.pdcp is None:
            self.pdcp = PdcpEntityNr(bearer=1, k_enc=self.k_enc,
                                     direction_tx=1)

    def pump_rx(self):
        """Demux every TB the worker delivered since the last pump
        (demux_nr.cc push_pdu path)."""
        while self.worker.delivered:
            tb = self.worker.delivered.pop(0)
            raw = np.packbits(np.asarray(tb, np.uint8)).tobytes()
            mac = MacPduNr.unpack(raw)
            for sdu in mac.sdus(LCID_DRB):
                self.rlc.write_pdu(sdu)
            while self.rlc.rx_sdus:
                pkt = self.pdcp.rx(self.rlc.rx_sdus.pop(0))
                if pkt is not None:
                    self.received.append(pkt)
