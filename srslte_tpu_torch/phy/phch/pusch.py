"""PUSCH physical channel processor (36.211 §5.3, pusch.c equivalent).

Reference behavior: lib/src/phy/phch/pusch.c — UL-SCH coding (same turbo
chain as DL-SCH, sch.c ulsch_encode:1194) -> channel interleaver (36.212
§5.2.2.8, time-first) -> scrambling -> modulation -> DFT transform precoding
-> mapping to contiguous PRBs skipping the DMRS symbols; decode reverses with
MMSE equalization and IDFT de-precoding.

The channel interleaver is one precomputed index per (G, Qm) bucket; DFT
precoding is a batched FFT; every table is built once per grant bucket and
kept on the device.  UCI (CQI/RI/ACK) multiplexing follows 36.212
§5.2.2.6-5.2.4 via host-precomputed scatter/gather plans (see uci.py); pass
a UciCfgUl to enable it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..chest.chest_ul import ChestUl
from ..chest.refsignal_ul import dmrs_symbol, pusch_dmrs
from ..common.params import Cell
from ..common.scrambling import pusch_cinit, scramble_bits, scramble_llr
from ..common.sequence import gold_sequence
from ..fec.cbsegm import cbsegm
from ..modem.modem import demod_soft, modulate
from .dft_precoding import dft_deprecode, dft_precode
from .dlsch import DlschConfig, dlsch_decode, dlsch_encode
from .ra_ul import UlGrant
from .uci import UciCfgUl, demux_llr, encode_cqi, mux_stream, scramble_fixups, uci_plan

UlschConfig = DlschConfig  # the SCH codec is shared (sch.c)


@functools.lru_cache(maxsize=None)
def data_symbols(cell: Cell) -> np.ndarray:
    """Subframe symbol indices carrying PUSCH data (DMRS symbols excluded)."""
    o = cell.ofdm
    ls = dmrs_symbol(cell)
    return np.asarray([l for l in range(o.nsymb_sf)
                       if l % o.nsymb_slot != ls], np.int32)


@functools.lru_cache(maxsize=None)
def interleaver_indices(g_bits: int, qm: int, n_symb: int) -> np.ndarray:
    """Channel interleaver gather: out[k] = in[idx[k]] (36.212 §5.2.2.8).

    Qm-bit groups are written row-wise into an [R, C=n_symb] matrix and read
    column-wise, so consecutive coded bits spread across SC-FDMA symbols.
    """
    h = g_bits // qm
    assert h % n_symb == 0, (g_bits, qm, n_symb)
    r = h // n_symb
    grp = np.arange(h).reshape(r, n_symb).T.reshape(-1)  # read column-wise
    idx = (grp[:, None] * qm + np.arange(qm)[None, :]).reshape(-1)
    return idx.astype(np.int32)


@dataclass(frozen=True)
class Pusch:
    """PUSCH processor for one (cell, grant, sf_idx, rnti) bucket."""

    cell: Cell
    grant: UlGrant
    sf_idx: int
    rnti: int = 0x46
    uci: UciCfgUl | None = None

    def __post_init__(self):
        if self.grant.prb_start + self.grant.n_prb > self.cell.n_prb:
            raise ValueError("PUSCH allocation exceeds cell bandwidth")

    @property
    def n_data_symbols(self) -> int:
        return len(data_symbols(self.cell))

    @property
    def m_sc(self) -> int:
        return self.grant.n_prb * 12

    @functools.cached_property
    def plan(self):
        """UCI multiplexing plan, or None for data-only transmissions."""
        if self.uci is None or not self.uci.has_uci:
            return None
        seg = cbsegm(self.grant.tbs)
        k_segm = seg.C1 * seg.K1 + seg.C2 * seg.K2  # sch.c:1228
        return uci_plan(self.m_sc, self.n_data_symbols,
                        self.grant.modulation.bits_per_symbol, k_segm,
                        self.uci)

    @functools.cached_property
    def cfg(self) -> UlschConfig:
        qm = self.grant.modulation.bits_per_symbol
        g = self.n_data_symbols * self.m_sc * qm
        if self.plan is not None:
            g = self.plan.g_data
        return UlschConfig(tbs=self.grant.tbs, G=g, Qm=qm, rv=self.grant.rv)

    @property
    def cinit(self) -> int:
        return pusch_cinit(self.rnti, self.sf_idx, self.cell.id)

    @functools.cached_property
    def _c_seq(self) -> np.ndarray:
        """The UCI stream's scrambling bits (host), built once per bucket."""
        return gold_sequence(self.cinit, self.plan.g_total)

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        """Flat grid indices, frequency-first per data symbol: [n_re]."""
        o = self.cell.ofdm
        k = self.grant.prb_start * 12 + np.arange(self.m_sc)
        return (data_symbols(self.cell)[:, None] * o.nof_re + k[None, :]
                ).reshape(-1).astype(np.int32)

    def _interleaver(self, device) -> torch.Tensor:
        key = ("pusch_interleaver", self.cfg.G, self.cfg.Qm, self.n_data_symbols)
        return table(key, device, lambda: interleaver_indices(
            self.cfg.G, self.cfg.Qm, self.n_data_symbols).astype(np.int64))

    # -- UE side --------------------------------------------------------------
    def encode(self, bits, grid=None, ack=None, ri=None, cqi=None, device=None):
        """bits [..., tbs] -> UL RE grid [..., nsymb_sf, nof_re] (complex64).

        Includes the DMRS so the output grid is transmit-ready for the
        SC-FDMA modulator (Ofdm with +0.5 freq shift).  ack/ri are payload
        bits ([o] or [..., o]); cqi is a host payload ([O] or [..., O],
        encoded on the host); all require a UciCfgUl on the processor.
        """
        bits = as_tensor(bits, device)
        dev = bits.device
        o = self.cell.ofdm
        qm = self.cfg.Qm
        coded = dlsch_encode(bits, self.cfg)
        if self.plan is not None:
            src = coded
            if self.plan.n_cqi_bits:
                cq = torch.as_tensor(encode_cqi(cqi, self.plan.n_cqi_bits)).to(dev)
                src = torch.cat([cq.to(coded.dtype).expand(coded.shape[:-1] + cq.shape[-1:]),
                                 coded], -1)
            stream = mux_stream(self.plan, src, ri=ri, ack=ack)
            scr = scramble_fixups(self.plan, scramble_bits(stream, self.cinit))
        else:
            scr = scramble_bits(coded[..., self._interleaver(dev)], self.cinit)
        sym = modulate(scr, self.grant.modulation)
        sym = sym.reshape(sym.shape[:-1] + (self.n_data_symbols, self.m_sc))
        freq = dft_precode(sym)  # [..., nsym_data, M]
        if grid is None:
            grid = torch.zeros(bits.shape[:-1] + (o.nsymb_sf, o.nof_re),
                               dtype=torch.complex64, device=dev)
        flat = as_tensor(grid, dev).to(torch.complex64).reshape(
            grid.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        re_key = ("pusch_re", self.cell, self.grant.prb_start, self.grant.n_prb)
        flat[..., table(re_key, dev, lambda: self.re_idx.astype(np.int64))] = \
            freq.reshape(freq.shape[:-2] + (-1,))
        grid = flat.reshape(grid.shape)
        # DMRS on symbol 3 of each slot
        ls = dmrs_symbol(self.cell)
        sym_idx = torch.as_tensor([ls, o.nsymb_slot + ls], device=dev)
        k0 = self.grant.prb_start * 12
        # the entry `ChestUl` reads for the same DMRS (n_dmrs2 = 0)
        grid[..., sym_idx, k0 : k0 + self.m_sc] = table(
            ("pusch_dmrs", self.cell, self.sf_idx, self.grant.n_prb, 0), dev,
            lambda: pusch_dmrs(self.cell, self.sf_idx, self.grant.n_prb))
        return grid

    # -- eNB side -------------------------------------------------------------
    def soft_bits(self, grid, ce, noise):
        """Equalise, de-precode, demodulate and descramble: the PUSCH REs of
        grid [..., nsymb_sf, nof_re] with the estimate ce [..., nsymb_sf, M]
        and noise [...] -> LLRs [..., g_total] (positive => bit 1).

        Per-SC MMSE, then one post-equalisation SNR weight per symbol (flat
        across the DFT block): mean |h|^2 over the allocation / noise.
        """
        k0 = self.grant.prb_start * 12
        dsym = table(("pusch_dsym", self.cell), grid.device,
                     lambda: data_symbols(self.cell).astype(np.int64))
        y = grid[..., dsym, k0 : k0 + self.m_sc]
        h = ce[..., dsym, :]
        nv = noise[..., None, None]
        xf = y * torch.conj(h) / (torch.abs(h) ** 2 + nv)  # per-SC MMSE
        x = dft_deprecode(xf)  # [..., nsym_data, M]
        gain = torch.mean(torch.abs(h) ** 2, dim=-1, keepdim=True)
        w = gain / torch.clamp(nv, min=1e-9)
        llr = demod_soft(x.reshape(x.shape[:-2] + (-1,)), self.grant.modulation)
        qm = self.cfg.Qm
        wq = torch.repeat_interleave(
            torch.broadcast_to(w, x.shape).reshape(x.shape[:-2] + (-1,)), qm, dim=-1)
        return scramble_llr(llr * wq, self.cinit)

    def demux(self, llr):
        """Descrambled LLRs [..., g_total] -> dict with the UCI decisions
        (`uci.demux_llr`) and "data_llr" [..., G], de-interleaved."""
        if self.plan is not None:
            return demux_llr(self.plan, llr, self._c_seq, self.uci)
        de_int = torch.zeros_like(llr)
        de_int[..., self._interleaver(llr.device)] = llr
        return {"data_llr": de_int}

    def decode(self, grid, n_iter: int = 5, device=None,
               siso_dtype: torch.dtype = torch.float32):
        """grid [..., nsymb_sf, nof_re] (post SC-FDMA demod) -> (bits, ok, info).

        Runs chest_ul internally (enb_ul.c style: estimate + equalize +
        de-precode + UL-SCH decode).  info holds the estimator's "noise" and
        "h_dmrs" and the UCI decisions of `demux`.  siso_dtype: the turbo
        decoder's working dtype (`dlsch.dlsch_decode`).
        """
        grid = as_tensor(grid, device).to(torch.complex64)
        ce, info = ChestUl(self.cell).estimate(grid, self.sf_idx, self.grant.prb_start,
                                               self.grant.n_prb)
        res = self.demux(self.soft_bits(grid, ce, info["noise"]))
        bits, ok = dlsch_decode(res.pop("data_llr"), self.cfg, n_iter=n_iter,
                                siso_dtype=siso_dtype)
        return bits, ok, {**info, **res}
