"""NR DL-SCH / UL-SCH coding chain (38.212 §5.2.2/§5.4.2/§7.2.4).

Reference behavior: lib/src/phy/phch/sch_nr.c — TB CRC (24A / 16),
base-graph selection, LDPC code-block segmentation with per-CB CRC24B and
fillers, per-CB rate matching (E split, rv, Qm interleaving), concatenation.

Static shapes per (tbs, R, G, Qm) bucket.  All code blocks of a TB go
through the encoder and the decoder as one batch (a code-block axis), and
the per-CB rate matching of a TB is one gather (TX) and one scatter-add
(RX) through an index over the C codewords laid end to end.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..fec import crc as crcmod
from ..fec.ldpc import (LdpcGraph, ldpc_decode, ldpc_encode, ldpc_rm_indices,
                        valid_lifting_sizes)


def select_bg(a: int, rate: float) -> int:
    """Base-graph selection (38.212 §7.2.2)."""
    if a <= 292 or (a <= 3824 and rate <= 0.67) or rate <= 0.25:
        return 2
    return 1


@dataclass(frozen=True)
class NrCbSegm:
    bg: int
    C: int
    zc: int
    K: int  # per-CB systematic length (incl. fillers + CB CRC)
    K_prime: int  # per-CB info bits (incl. CB CRC, excl. fillers)
    F: int  # filler bits per CB
    tb_crc_len: int
    cb_crc_len: int


def nr_cbsegm(a: int, rate: float) -> NrCbSegm:
    """38.212 §5.2.2 segmentation for TB size `a` (payload bits)."""
    bg = select_bg(a, rate)
    tb_crc = 24 if a > 3824 else 16
    b = a + tb_crc
    kcb = 8448 if bg == 1 else 3840
    if b <= kcb:
        c, l_cb, b_prime = 1, 0, b
    else:
        l_cb = 24
        c = -(-b // (kcb - l_cb))
        b_prime = b + c * l_cb
    k_prime = -(-b_prime // c)
    if bg == 1:
        kb = 22
    else:
        kb = 10 if b > 640 else 9 if b > 560 else 8 if b > 192 else 6
    zc = min(z for z in valid_lifting_sizes() if kb * z >= k_prime)
    k = (22 if bg == 1 else 10) * zc
    return NrCbSegm(bg=bg, C=c, zc=zc, K=k, K_prime=k_prime, F=k - k_prime,
                    tb_crc_len=tb_crc, cb_crc_len=l_cb)


@dataclass(frozen=True)
class NrDlschConfig:
    """Static bucket for one NR transport block."""

    tbs: int
    G: int
    Qm: int
    rate: float  # target code rate (drives BG selection)
    rv: int = 0
    n_layers: int = 1

    @functools.cached_property
    def seg(self) -> NrCbSegm:
        return nr_cbsegm(self.tbs, self.rate)

    @functools.cached_property
    def graph(self) -> LdpcGraph:
        return LdpcGraph(self.seg.bg, self.seg.zc)

    @functools.cached_property
    def e_per_cb(self) -> tuple:
        """E_r per code block (38.212 §5.4.2.1 split)."""
        s = self.seg
        unit = self.n_layers * self.Qm
        gp = self.G // unit
        lo = unit * (gp // s.C)
        hi = unit * (-(-gp // s.C))
        gamma = gp % s.C
        return tuple(lo if r <= s.C - gamma - 1 else hi for r in range(s.C))

    def rm_index(self, device) -> torch.Tensor:
        """[sum E_r] positions in the C codewords laid end to end
        ([C * n_full]): code block r's rate-matching gather, offset by
        r * n_full, the blocks in order."""
        def build():
            g = self.graph
            return np.concatenate([
                ldpc_rm_indices(g, e, self.rv, self.Qm, self.seg.K_prime).astype(np.int64)
                + r * g.n_full for r, e in enumerate(self.e_per_cb)])
        key = ("nr_sch_rm", self.seg, self.e_per_cb, self.rv, self.Qm)
        return table(key, device, build)


def _tb_poly(s: NrCbSegm):
    return crcmod.LTE_CRC24A if s.tb_crc_len == 24 else crcmod.LTE_CRC16


def nr_dlsch_encode(bits, cfg: NrDlschConfig, device=None):
    """bits [..., tbs] -> coded [..., G] uint8."""
    bits = as_tensor(bits, device)
    s = cfg.seg
    lead = bits.shape[:-1]
    b = bits.to(torch.float32)
    b = torch.cat([b, crcmod.crc_calc(b, *_tb_poly(s))], dim=-1)
    data_per_cb = s.K_prime - s.cb_crc_len
    if b.shape[-1] != s.C * data_per_cb:
        raise ValueError(f"TB of {cfg.tbs} bits does not split into {s.C} equal code blocks")
    cb = b.reshape(lead + (s.C, data_per_cb))
    if s.cb_crc_len:
        cb = torch.cat([cb, crcmod.crc_calc(cb, *crcmod.LTE_CRC24B)], dim=-1)
    if s.F:
        cb = torch.cat([cb, cb.new_zeros(lead + (s.C, s.F))], dim=-1)
    cw = ldpc_encode(cb, cfg.graph)  # [..., C, n_full]
    return cw.reshape(lead + (-1,))[..., cfg.rm_index(cw.device)]


def nr_dlsch_combine(llr, cfg: NrDlschConfig, state=None, device=None):
    """Scatter llr [..., G] into full-codeword softbuffers [..., C, n_full].

    state is a previous softbuffer to IR-combine into (HARQ retransmission
    with cfg.rv of THIS transmission), or None for a first transmission.
    Analog of srsran softbuffer + ldpc_rm.c combining.  A position sent more
    than once gets the sum of its copies (`index_add_`); the filler prior
    is -1e4 on a first transmission and already in `state` on a combine.
    """
    llr = as_tensor(llr, device)
    s, g = cfg.seg, cfg.graph
    lead = llr.shape[:-1]
    flat = llr.reshape((-1, llr.shape[-1]))
    w = flat.new_zeros((flat.shape[0], s.C * g.n_full))
    w.index_add_(1, cfg.rm_index(llr.device), flat)
    w = w.reshape(lead + (s.C, g.n_full))
    fill = torch.zeros(g.n_full, dtype=w.dtype, device=w.device)
    if s.K_prime < g.k and state is None:
        fill[s.K_prime : g.k].fill_(-1e4)
    w = w + fill
    return w if state is None else state + w


def nr_dlsch_decode_state(w, cfg: NrDlschConfig, n_iter: int = 10, device=None):
    """Decode softbuffers [..., C, n_full] -> (bits [..., tbs], ok [...])."""
    w = as_tensor(w, device)
    s = cfg.seg
    data_per_cb = s.K_prime - s.cb_crc_len
    hard, ok_pc = ldpc_decode(w, cfg.graph, n_iter=n_iter)  # [..., C, K..]
    cb = hard[..., : s.K_prime]
    if s.cb_crc_len:
        ok_cb = crcmod.crc_ok_device(cb, *crcmod.LTE_CRC24B) & ok_pc
        cb = cb[..., :data_per_cb]
    else:
        ok_cb = ok_pc
    b = cb.reshape(cb.shape[:-2] + (s.C * data_per_cb,))
    ok = crcmod.crc_ok_device(b, *_tb_poly(s)) & torch.all(ok_cb, dim=-1)
    return b[..., : cfg.tbs].to(torch.uint8), ok


def nr_dlsch_decode(llr, cfg: NrDlschConfig, n_iter: int = 10, device=None):
    """llr [..., G] (positive => bit 1) -> (bits [..., tbs], ok [...])."""
    return nr_dlsch_decode_state(nr_dlsch_combine(llr, cfg, device=device), cfg,
                                 n_iter=n_iter)
