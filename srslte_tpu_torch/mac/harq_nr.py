"""NR HARQ entities with LDPC incremental-redundancy soft combining.

Reference behavior: srsue/src/stack/mac_nr/dl_harq_nr.cc (up to 16
processes, new TB on NDI toggle / rv==0 broadcast / first tx, softbuffer
reset then IR combining across retransmissions) and ul_harq_nr.cc (rv
cycling 0,2,3,1 with nof_retx bounded by max_retx).

A softbuffer is the full-codeword LLR tensor [C, n_full] on the device of
the LLRs, which phy/nr/dlsch_nr.nr_dlsch_combine adds each transmission's
rate-matched LLRs into, so a retransmission with a different rv (even a
different G) accumulates before one batched LDPC decode.  A decode makes
one host read: the CRC flag and the bits together.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..phy.nr.dlsch_nr import NrDlschConfig, nr_dlsch_combine, nr_dlsch_decode_state

RV_SEQ_NR = (0, 2, 3, 1)  # ul_harq_nr.cc rv cycling order
N_PROC_NR = 16  # SRSRAN_MAX_HARQ_PROC_DL_NR


@dataclass
class NrHarqProc:
    ndi: int | None = None
    state: object | None = None
    n_retx: int = 0
    decoded: bool = False


@dataclass
class NrDlHarqEntity:
    """UE-side DL HARQ: soft combining across retransmissions per process."""

    procs: list = field(
        default_factory=lambda: [NrHarqProc() for _ in range(N_PROC_NR)])

    def rx(self, pid: int, ndi: int, llr, cfg: NrDlschConfig,
           n_iter: int = 10, device=None):
        """Process one transmission: returns (ack, bits|None), the bits a
        host uint8 array.

        cfg.rv must be THIS transmission's rv (dl_harq_nr.cc:96 new-TB
        detection on NDI toggle; otherwise combine into the softbuffer).
        """
        p = self.procs[pid]
        if p.ndi is None or ndi != p.ndi:  # new transport block
            p.ndi, p.state, p.n_retx, p.decoded = ndi, None, 0, False
        else:
            p.n_retx += 1
        if p.decoded:
            return True, None  # duplicate of a delivered TB; ack again
        p.state = nr_dlsch_combine(llr, cfg, p.state, device=device)
        bits, ok = nr_dlsch_decode_state(p.state, cfg, n_iter=n_iter)
        host = torch.cat([ok.reshape(1).to(torch.uint8), bits]).cpu().numpy()
        if host[0]:
            p.decoded = True
            p.state = None  # free the softbuffer
            return True, host[1:]
        return False, None


@dataclass
class NrTxHarqProc:
    ndi: int = 0
    bits: np.ndarray | None = None
    n_tx: int = 0
    active: bool = False


@dataclass
class NrTxHarqEntity:
    """Transmit-side HARQ (gNB DL or UE UL): rv cycling on NACK.

    ul_harq_nr.cc analog: new_tx toggles NDI and restarts the rv sequence,
    retx advances it; the TB is dropped after max_retx retransmissions.
    """

    max_retx: int = 4
    procs: list = field(
        default_factory=lambda: [NrTxHarqProc() for _ in range(N_PROC_NR)])

    def free_pid(self) -> int | None:
        for i, p in enumerate(self.procs):
            if not p.active:
                return i
        return None

    def new_tx(self, pid: int, bits: np.ndarray) -> tuple[int, int]:
        """Start a TB on pid: returns (ndi, rv=0)."""
        p = self.procs[pid]
        p.ndi ^= 1
        p.bits, p.n_tx, p.active = bits, 1, True
        return p.ndi, RV_SEQ_NR[0]

    def retx(self, pid: int) -> tuple[int, int] | None:
        """NACK: next (ndi, rv), or None when max_retx is exhausted."""
        p = self.procs[pid]
        if not p.active:
            return None
        if p.n_tx > self.max_retx:
            p.active, p.bits = False, None  # drop the TB
            return None
        rv = RV_SEQ_NR[p.n_tx % len(RV_SEQ_NR)]
        p.n_tx += 1
        return p.ndi, rv

    def ack(self, pid: int):
        p = self.procs[pid]
        p.active, p.bits = False, None
