"""PMCH: multicast channel over MBSFN subframes (36.211 §6.5/§6.10.2).

Reference behavior: lib/src/phy/phch/pmch.c (pmch_put:60, encode/decode,
srsran_configure_pmch:384, scrambling c_init = (sf_idx << 9) + area_id from
sequences.c srsran_sequence_pmch:174) and ch_estimation/refsignal_dl.c
MBSFN reference signals (gen_seq:385: c_init = 512(7(slot+1)+l'+1)(2N+1)+N,
pilot offset 3*(110 - n_prb), 6 pilots/PRB at symbols 2/6/10 of the
extended-CP subframe, subcarrier offsets 0/1/0).

Modeling note: the C library builds MBSFN subframes with a mixed-CP OFDM
(normal-CP control symbols + extended-CP MBSFN region).  Here the whole
subframe lives on the extended-CP grid (12 symbols) with the control region
occupying the first `non_mbsfn_region` symbols: the PMCH RE geometry, RS
pattern, scrambling and TBS math are faithful; only the CP length of the
two control symbols differs.

Full-band static RE gathers as in pdsch.py; no transmit diversity (single
antenna port 4, pmch.c:339 "No tx diversity in MBSFN").
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ...utils.jit import lazy_jit
from ..common.params import CP, Cell
from ..common.scrambling import scramble_bits, scramble_llr
from ..common.sequence import gold_sequence
from ..mimo import equalize_zf
from ..modem.modem import demod_soft, modulate
from .dlsch import DlschConfig, dlsch_decode, dlsch_encode
from .ra import DlGrant, dl_tbs

MBSFN_RS_SYMBOLS = (2, 6, 10)  # extended-CP subframe symbol indices
_RS_FIDX = (0, 1, 0)  # subcarrier offset per RS symbol (refsignal_dl.c)
MAX_PRB = 110


def pmch_cinit(sf_idx: int, area_id: int) -> int:
    """36.211 §6.5.1 scrambling (sequences.c srsran_sequence_pmch)."""
    return ((sf_idx << 9) + area_id) % (1 << 31)


@functools.lru_cache(maxsize=None)
def mbsfn_rs_values(n_prb: int, area_id: int, sf_idx: int) -> np.ndarray:
    """[3, 6 * n_prb] complex pilots for the three MBSFN RS symbols."""
    out = np.zeros((3, 6 * n_prb), np.complex64)
    for li, nsym in enumerate(MBSFN_RS_SYMBOLS):
        lp = nsym % 6
        slot = 2 * sf_idx + (1 if li else 0)
        c_init = (512 * (7 * (slot + 1) + lp + 1) * (2 * area_id + 1)
                  + area_id) % (1 << 31)
        c = gold_sequence(c_init, 2 * 6 * MAX_PRB).astype(np.float32)
        mp = np.arange(6 * n_prb) + 3 * (MAX_PRB - n_prb)
        out[li] = ((1 - 2 * c[2 * mp]) + 1j * (1 - 2 * c[2 * mp + 1])) / np.sqrt(2)
    return out


@functools.lru_cache(maxsize=None)
def mbsfn_rs_subcarriers(n_prb: int) -> np.ndarray:
    """[3, 6 * n_prb] subcarrier index per pilot."""
    base = 2 * np.arange(6 * n_prb)
    return np.stack([base + f for f in _RS_FIDX]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def pmch_re_indices(cell: Cell, non_mbsfn_region: int = 2) -> np.ndarray:
    """Flat ext-CP-grid indices of PMCH REs (full band, RS punctured)."""
    if cell.cp is not CP.EXT:
        raise ValueError("the MBSFN region uses the extended CP")
    o = cell.ofdm
    rs_sc = {s: set(mbsfn_rs_subcarriers(cell.n_prb)[i].tolist())
             for i, s in enumerate(MBSFN_RS_SYMBOLS)}
    idx = []
    for l in range(non_mbsfn_region, o.nsymb_sf):
        ks = np.arange(o.nof_re)
        if l in rs_sc:
            keep = np.array([k not in rs_sc[l] for k in ks])
            ks = ks[keep]
        idx.append(l * o.nof_re + ks)
    return np.concatenate(idx).astype(np.int32)


@dataclass(frozen=True)
class Pmch:
    """PMCH processor for one (cell, area, sf, mcs) bucket.

    The grant is always full-band single-TB (srsran_configure_pmch).
    """

    cell: Cell
    area_id: int
    sf_idx: int
    mcs: int
    non_mbsfn_region: int = 2

    def __post_init__(self):
        if self.cell.cp is not CP.EXT:
            raise ValueError("PMCH runs on an extended-CP cell")

    @functools.cached_property
    def grant(self) -> DlGrant:
        return DlGrant.full(self.cell.n_prb, self.mcs)

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        return pmch_re_indices(self.cell, self.non_mbsfn_region)

    @functools.cached_property
    def cfg(self) -> DlschConfig:
        qm = self.grant.modulation.bits_per_symbol
        return DlschConfig(tbs=dl_tbs(self.mcs, self.cell.n_prb),
                           G=len(self.re_idx) * qm, Qm=qm, rv=0)

    @property
    def cinit(self) -> int:
        return pmch_cinit(self.sf_idx, self.area_id)

    def _tables(self, device):
        """(flat PMCH RE indices, flat RS indices [3, 6 n_prb], RS values)."""
        o = self.cell.ofdm
        idx = table(("pmch_re", self.cell, self.non_mbsfn_region), device,
                    lambda: self.re_idx.astype(np.int64))
        rs_idx = table(("mbsfn_rs_re", self.cell.n_prb, o.nof_re), device, lambda: (
            np.asarray(MBSFN_RS_SYMBOLS)[:, None] * o.nof_re
            + mbsfn_rs_subcarriers(self.cell.n_prb)).astype(np.int64))
        vals = table(("mbsfn_rs", self.cell.n_prb, self.area_id, self.sf_idx), device,
                     lambda: mbsfn_rs_values(self.cell.n_prb, self.area_id, self.sf_idx))
        return idx, rs_idx, vals

    def put_rs(self, grids, device=None):
        """Write the MBSFN reference signals (port 4); a new tensor."""
        grids = as_tensor(grids, device)
        o = self.cell.ofdm
        _, rs_idx, vals = self._tables(grids.device)
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        flat[..., rs_idx] = vals
        return flat.reshape(grids.shape)

    def encode(self, bits, grids, device=None):
        """bits [..., tbs] -> grids [..., nsym_sf, nof_re] with PMCH + RS."""
        grids = as_tensor(grids, device)
        bits = as_tensor(bits, grids.device)
        o = self.cell.ofdm
        idx, _, _ = self._tables(grids.device)
        coded = dlsch_encode(bits, self.cfg)
        scr = scramble_bits(coded, self.cinit)
        sym = modulate(scr, self.grant.modulation)
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        flat[..., idx] = sym
        return self.put_rs(flat.reshape(grids.shape))

    def chest(self, grid, device=None):
        """LS at the MBSFN RS -> (ce [..., nsym, nof_re], noise_var).

        The noise is one value: the mean over every pilot of the batch, as
        in the reference."""
        grid = as_tensor(grid, device)
        o = self.cell.ofdm
        _, rs_idx, vals = self._tables(grid.device)
        ls = grid.reshape(grid.shape[:-2] + (-1,))[..., rs_idx] * torch.conj(vals)  # [..., 3, 6n]
        # time-average (MBSFN channels are long but static within a subframe
        # at this scope)
        h_f = ls.mean(dim=-2)
        # every-other-subcarrier -> full band linear interp
        nxt = torch.cat([h_f[..., 1:], h_f[..., -1:]], dim=-1)
        ce_pairs = torch.stack([h_f, (h_f + nxt) / 2], dim=-1)
        ce = ce_pairs.reshape(ce_pairs.shape[:-2] + (-1,))[..., : o.nof_re]
        noise = torch.mean(torch.abs(ls - h_f[..., None, :]) ** 2)
        ce_sf = ce[..., None, :].expand(ce.shape[:-1] + (o.nsymb_sf, o.nof_re))
        return ce_sf, torch.clamp(noise, min=1e-9)

    @lazy_jit(static_argnums=(0,), static_argnames=("n_iter",))
    def decode(self, grid, n_iter: int = 5, device=None,
               siso_dtype: torch.dtype = torch.float32):
        """grid [..., nsym_sf, nof_re] -> (bits, crc_ok): the estimate, the
        soft bits and DL-SCH decoding."""
        grid = as_tensor(grid, device)
        ce, noise = self.chest(grid)
        idx, _, _ = self._tables(grid.device)
        y = grid.reshape(grid.shape[:-2] + (-1,))[..., idx]
        h = ce.reshape(ce.shape[:-2] + (-1,))[..., idx]
        xhat = equalize_zf(y, h)
        w = torch.abs(h) ** 2 / noise
        llr = demod_soft(xhat, self.grant.modulation)
        qm = self.grant.modulation.bits_per_symbol
        llr = llr * torch.repeat_interleave(w, qm, dim=-1)
        llr = scramble_llr(llr, self.cinit)
        return dlsch_decode(llr, self.cfg, n_iter, siso_dtype=siso_dtype)
