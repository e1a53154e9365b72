"""HARQ entities with incremental-redundancy soft combining.

Reference behavior: srsue/src/stack/mac/{dl_harq.cc, ul_harq.cc} (8 processes,
NDI toggles, rv sequence 0,2,3,1) over lib/src/phy/fec/softbuffer.c (the
dcat/circular-buffer-domain soft LLR store that rate matching combines into,
rm_turbo.c:390).

A soft buffer is a tuple of device tensors, one per code-block group of the
transport block, each [..., count, 3*(K+4)].  Combining is the rate
matcher's inverse (`turbo.rm_rx`, a masked gather-sum) added to the buffer,
so retransmissions with different rv (even different G) accumulate before
one batched turbo decode.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import as_tensor
from ..phy.fec import crc as crcmod
from ..phy.fec import turbo
from ..phy.fec.tdec import turbo_decode
from ..phy.phch.dlsch import DlschConfig

RV_SEQ = (0, 2, 3, 1)  # 36.213 §7.1.7.3 retransmission rv order
N_PROC = 8


def combine_llr(llr, cfg: DlschConfig, state=None, device=None):
    """Add received LLRs [..., G] (positive => bit 1) into dcat soft buffers.

    state: tuple of per-group tensors [..., count, 3*(K+4)] or None (first
    transmission).  Returns the new state.  cfg.rv selects the
    circular-buffer offset.
    """
    llr = as_tensor(llr, device, torch.float32)
    new = []
    pos = 0
    batch = llr.shape[:-1]
    for gi, g in enumerate(cfg.groups):
        block = llr[..., pos : pos + g.count * g.E]
        pos += g.count * g.E
        e = block.reshape(batch + (g.count, g.E))
        w = turbo.rm_rx(e, g.K, rv=cfg.rv, f=g.F)
        if state is not None:
            w = w + state[gi]
        new.append(w)
    return tuple(new)


def decode_state(state, cfg: DlschConfig, n_iter: int = 5,
                 siso_dtype: torch.dtype = torch.float32):
    """Decode accumulated soft buffers -> (bits [..., tbs] uint8, crc_ok [...]).

    The groups that share a K decode as one batch (the E of 36.212's bit
    selection splits a transport block into two groups of one K): a code
    block's float32 decode does not depend on its batch, so the result is
    the per-group decode's.  With `siso_dtype` bfloat16 the merged batch
    shares one scale (`tdec.turbo_start`).
    """
    seg = cfg.seg
    batch = state[0].shape[:-2]
    hard_of = {}
    for K in dict.fromkeys(g.K for g in cfg.groups):
        gis = [i for i, g in enumerate(cfg.groups) if g.K == K]
        flats = [state[i].reshape((-1, state[i].shape[-1])) for i in gis]
        hard, _ = turbo_decode(torch.cat(flats), K, n_iter=n_iter, siso_dtype=siso_dtype)
        for i, h in zip(gis, torch.split(hard, [f.shape[0] for f in flats])):
            hard_of[i] = h.reshape(batch + (cfg.groups[i].count, K))
    parts, ok_parts = [], []
    for gi, g in enumerate(cfg.groups):
        hard = hard_of[gi]
        if seg.C > 1:
            pb, po = crcmod.LTE_CRC24B
            ok_parts.append(crcmod.crc_ok_device(hard, pb, po))
            payload = hard[..., g.F : g.K - 24]
        else:
            payload = hard[..., g.F :]
        parts.append(payload.reshape(batch + (g.count * g.data_bits,)))
    b = torch.cat(parts, dim=-1)
    pa, oa = crcmod.LTE_CRC24A
    ok = crcmod.crc_ok_device(b, pa, oa)
    if ok_parts:
        ok = ok & torch.all(torch.cat(ok_parts, dim=-1), dim=-1)
    return b[..., : cfg.tbs].to(torch.uint8), ok


@dataclass
class HarqProc:
    ndi: int | None = None
    state: tuple | None = None
    n_retx: int = 0
    decoded: bool = False


@dataclass
class DlHarqEntity:
    """UE-side DL HARQ: soft combining across retransmissions per process."""

    procs: list = field(default_factory=lambda: [HarqProc() for _ in range(N_PROC)])

    def rx(self, pid: int, ndi: int, llr, cfg: DlschConfig, n_iter: int = 5,
           device=None, siso_dtype: torch.dtype = torch.float32):
        """Process a transmission: returns (ack, bits tensor | None)."""
        p = self.procs[pid]
        if p.ndi is None or ndi != p.ndi:  # new transport block
            p.ndi, p.state, p.n_retx, p.decoded = ndi, None, 0, False
        else:
            p.n_retx += 1
        if p.decoded:
            return True, None  # already delivered; ack again
        p.state = combine_llr(llr, cfg, p.state, device)
        bits, ok = decode_state(p.state, cfg, n_iter=n_iter, siso_dtype=siso_dtype)
        if bool(ok.all()):
            p.decoded = True
            p.state = None  # free the softbuffer
            return True, bits
        return False, None


@dataclass
class TxHarqProc:
    ndi: int = 0
    tbs: int = 0
    bits: np.ndarray | None = None
    n_tx: int = 0


@dataclass
class UlHarqEntity:
    """UE-side UL HARQ (synchronous, 8 ms RTT): rv cycling on NACK."""

    max_retx: int = 4
    procs: list = field(default_factory=lambda: [TxHarqProc() for _ in range(N_PROC)])

    def new_tx(self, pid: int, bits: np.ndarray):
        p = self.procs[pid]
        p.ndi ^= 1
        p.bits = bits
        p.n_tx = 1
        return p.ndi, RV_SEQ[0]

    def retx(self, pid: int):
        """On NACK: returns (rv, bits) or None when max retx exhausted."""
        p = self.procs[pid]
        if p.bits is None or p.n_tx >= self.max_retx:
            p.bits = None
            return None
        rv = RV_SEQ[p.n_tx % 4]
        p.n_tx += 1
        return rv, p.bits

    def ack(self, pid: int):
        self.procs[pid].bits = None
