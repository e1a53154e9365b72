"""NR slot workers: gNB DL scheduling + UE blind decode with HARQ feedback.

Reference behavior: srsenb/src/phy/nr/cc_worker.cc (encode PDCCH+PDSCH per
slot from the scheduler's grants) and srsue/src/phy/nr/cc_worker.cc
(blind DCI search -> PDSCH decode -> UCI on PUCCH), with the MAC-NR HARQ
entities of srsue/src/stack/mac_nr/{dl_harq_nr.cc, ul_harq_nr.cc}.

One slot is one [NSYMB_SLOT, nof_re] grid on the workers' device
(`NrWorkerCommon.device`; None means the CUDA device).  The scheduler and
the HARQ bookkeeping run on the host; a slot reads the device back at the
DCI search (its list decoder's candidates), at the HARQ decode (CRC flag
and bits) and at the PUCCH ACK.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ._device import as_tensor, resolve
from .mac.harq_nr import NrDlHarqEntity, NrTxHarqEntity
from .phy.nr import (Coreset, Dci10, NrCarrier, NrGrant, NrPdcch, NrPdsch,
                     NrSearchSpace, dci_10_size, pack_dci_10,
                     pdcch_nr_locations, unpack_dci_10)
from .phy.nr.params import NSYMB_SLOT
from .phy.nr.pucch_nr import NrPucch, NrPucchResource

AGG_L = 4  # aggregation level both ends use for the UE-specific space
AGG_IDX = 2


def _ack_resource() -> NrPucchResource:
    """The configured PUCCH resource carrying HARQ-ACK (format 1)."""
    return NrPucchResource(format=1, starting_prb=0, start_symbol=4,
                           nof_symbols=10, initial_cyclic_shift=3)


@dataclass
class NrWorkerCommon:
    """Shared cell configuration (the gNB's RRC would signal this)."""

    carrier: NrCarrier
    coreset: Coreset
    rnti: int = 0x4601
    mcs: int = 20
    mcs_table: str = "qam64"
    prb_start: int = 4
    n_prb: int = 24
    device: object = None  # where the slot grids live; None: the CUDA device

    def search_space(self) -> NrSearchSpace:
        return NrSearchSpace(ue_specific=True,
                             nof_candidates=(0, 0, 2, 2, 0))

    def phy_grant(self, rv: int) -> NrGrant:
        return NrGrant(prb_start=self.prb_start, n_prb=self.n_prb,
                       mcs=self.mcs, mcs_table=self.mcs_table, rv=rv)


@dataclass
class GnbNrWorker:
    """gNB side: schedules queued TBs as DCI 1_0 + PDSCH, retx on NACK."""

    cfg: NrWorkerCommon
    harq: NrTxHarqEntity = field(default_factory=NrTxHarqEntity)
    queue: list = field(default_factory=list)  # pending new TBs (bit arrays)
    _awaiting: dict = field(default_factory=dict)  # pid -> rv of last tx
    _nacked: list = field(default_factory=list)  # pids to retransmit
    dropped: int = 0

    def tx_data(self, bits: np.ndarray):
        self.queue.append(np.asarray(bits, np.uint8))

    def tx_slot(self, slot: int):
        """Build this slot's DL grid (or None when idle)."""
        pid = ndi = rv = None
        if self._nacked:
            pid = self._nacked.pop(0)
            nr = self.harq.retx(pid)
            if nr is None:  # max_retx exhausted: drop, fall through to new
                self.dropped += 1
            else:
                ndi, rv = nr
        if rv is None and self.queue:
            pid = self.harq.free_pid()
            if pid is not None:
                ndi, rv = self.harq.new_tx(pid, self.queue.pop(0))
        if rv is None:
            return None
        c = self.cfg
        grant = c.phy_grant(rv)
        pdsch = NrPdsch(c.carrier, rnti=c.rnti, slot=slot, grant=grant)
        grid = pdsch.encode(as_tensor(self.harq.procs[pid].bits, resolve(c.device)))
        dci = Dci10(rb_start=c.prb_start, l_rb=c.n_prb, mcs=c.mcs, ndi=ndi,
                    rv=rv, harq_pid=pid)
        pdcch = NrPdcch(c.carrier, c.coreset, slot=slot)
        locs = pdcch_nr_locations(c.coreset, c.search_space(), c.rnti,
                                  AGG_IDX, slot)
        grid = pdcch.encode(grid, pack_dci_10(dci, c.carrier.n_prb),
                            c.rnti, locs[0], AGG_L)
        self._awaiting[pid] = rv
        return grid

    def rx_ul_slot(self, grid, slot: int):
        """Decode HARQ-ACK on PUCCH; NACK schedules a retransmission."""
        if not self._awaiting:
            return
        pucch = NrPucch(self.cfg.carrier, slot=slot)
        bits, _ = pucch.format1_decode(as_tensor(grid, self.cfg.device),
                                       _ack_resource(), 1)
        # single configured UE: the oldest awaiting pid is being acked
        pid = next(iter(self._awaiting))
        del self._awaiting[pid]
        if bits[0] == 1:
            self.harq.ack(pid)
        else:
            self._nacked.append(pid)


@dataclass
class UeNrWorker:
    """UE side: blind DCI search, HARQ soft combining, ACK on PUCCH."""

    cfg: NrWorkerCommon
    harq: NrDlHarqEntity = field(default_factory=NrDlHarqEntity)
    delivered: list = field(default_factory=list)

    def rx_slot(self, grid, slot: int):
        """Decode one DL slot; returns the UL grid (PUCCH ACK) or None."""
        c = self.cfg
        grid = as_tensor(grid, c.device)
        pdcch = NrPdcch(c.carrier, c.coreset, slot=slot)
        locs = pdcch_nr_locations(c.coreset, c.search_space(), c.rnti,
                                  AGG_IDX, slot)
        hit = pdcch.search(grid, c.rnti, dci_10_size(c.carrier.n_prb),
                           [(n, AGG_L) for n in locs])
        if hit is None:
            return None
        dci = unpack_dci_10(hit[1], c.carrier.n_prb)
        if dci is None:
            return None
        grant = c.phy_grant(dci.rv)
        pdsch = NrPdsch(c.carrier, rnti=c.rnti, slot=slot, grant=grant)
        llr, _ = pdsch.demod_llr(grid)
        ack, bits = self.harq.rx(dci.harq_pid, dci.ndi, llr, pdsch.cfg)
        if bits is not None:
            self.delivered.append(bits)
        ul = torch.zeros((NSYMB_SLOT, c.carrier.nof_re), dtype=torch.complex64,
                         device=grid.device)
        pucch = NrPucch(c.carrier, slot=slot)
        return pucch.format1_encode(ul, _ack_resource(),
                                    np.array([1 if ack else 0], np.uint8))
