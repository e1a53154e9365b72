"""PDSCH physical channel processor (36.211 §6.4, pdsch.c equivalent).

Reference behavior: lib/src/phy/phch/pdsch.c (srsran_pdsch_encode:1017,
srsran_pdsch_decode:788) and prb_dl.c RE mapping.  Encode: DL-SCH coding ->
scrambling -> modulation -> RE mapping.  Decode: RE extraction -> equalize ->
soft demod -> descramble -> DL-SCH decode.

The RE map (around CRS / control region / PBCH / sync) is a static gather
index per (cell, grant, sf class, cfi) bucket, so a whole subframe's PDSCH
moves with two gathers.  Ported: one antenna port (TM1).  Transmit diversity
and spatial multiplexing (`PdschSm`, `PdschSm4`) are ROADMAP queue A item 8.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..chest.refsignal_dl import crs_mask
from ..common.params import Cell
from ..common.scrambling import pdsch_cinit, scramble_bits, scramble_llr
from ..mimo import equalize_zf
from ..modem.modem import demod_soft, modulate
from .dlsch import DlschConfig, dlsch_decode, dlsch_encode
from .ra import DlGrant
from .regs import nof_ctrl_symbols


def sf_flags(sf_idx: int) -> tuple[bool, bool]:
    """(has_pss_sss, has_pbch) for FDD (36.211 §6.11/6.6)."""
    return (sf_idx % 5 == 0, sf_idx == 0)


@functools.lru_cache(maxsize=None)
def reserved_mask(cell: Cell, cfi: int, has_pss_sss: bool, has_pbch: bool) -> np.ndarray:
    """[nsym_sf, nof_re] True where PDSCH must NOT map.

    `cfi` is the CFI value; narrow cells (<=10 PRB) spend cfi+1 symbols on
    control (36.212 §5.3.4, regs.c nof_ctrl_symbols).
    """
    o = cell.ofdm
    m = crs_mask(cell).copy()
    m[: nof_ctrl_symbols(cell, cfi), :] = True  # control region
    mid = o.nof_re // 2
    if has_pss_sss:
        # PSS symbol 6, SSS symbol 5 (normal CP slot 0), center 72 subcarriers
        nsym_slot = o.nsymb_slot
        m[nsym_slot - 1, mid - 36 : mid + 36] = True
        m[nsym_slot - 2, mid - 36 : mid + 36] = True
    if has_pbch:
        # PBCH: slot 1 symbols 0..3, center 72 subcarriers
        for l in range(4):
            m[o.nsymb_slot + l, mid - 36 : mid + 36] = True
    return m


@functools.lru_cache(maxsize=None)
def pdsch_re_indices(cell: Cell, prb_mask: tuple, cfi: int,
                     has_pss_sss: bool, has_pbch: bool,
                     prb_mask_slot1: tuple | None = None,
                     last_symbol: int | None = None) -> np.ndarray:
    """Flattened grid indices (sym*nof_re + k), frequency-first then symbol.

    `prb_mask_slot1` (distributed-VRB slot hopping, 36.211 §6.2.3.2) selects
    a different PRB set for the odd slot's symbols; None = same both slots.
    `last_symbol` truncates the mapping (TDD DwPTS: only the first
    `nof_dw` symbols of a special subframe carry PDSCH).
    """
    o = cell.ofdm
    res = reserved_mask(cell, cfi, has_pss_sss, has_pbch)

    def sc_mask(mask):
        sc = np.zeros(o.nof_re, bool)
        for i, used in enumerate(mask):
            if used:
                sc[i * 12 : (i + 1) * 12] = True
        return sc

    sc0 = sc_mask(prb_mask)
    sc1 = sc0 if prb_mask_slot1 is None else sc_mask(prb_mask_slot1)
    n_sym = o.nsymb_sf if last_symbol is None else min(last_symbol, o.nsymb_sf)
    idx = []
    for l in range(n_sym):
        sc = sc0 if l < o.nsymb_slot else sc1
        ks = np.where(sc & ~res[l])[0]
        idx.append(l * o.nof_re + ks)
    return np.concatenate(idx).astype(np.int32)


def nof_re_pdsch(cell: Cell, grant: DlGrant, sf_idx: int, cfi: int,
                 last_symbol: int | None = None) -> int:
    ps, pb = sf_flags(sf_idx)
    return len(pdsch_re_indices(cell, grant.prb_mask, cfi, ps, pb,
                                grant.prb_mask_slot1, last_symbol))


def dlsch_config(cell: Cell, grant: DlGrant, sf_idx: int, cfi: int,
                 last_symbol: int | None = None) -> DlschConfig:
    n_re = nof_re_pdsch(cell, grant, sf_idx, cfi, last_symbol)
    return DlschConfig(tbs=grant.tbs, G=n_re * grant.modulation.bits_per_symbol,
                       Qm=grant.modulation.bits_per_symbol, rv=grant.rv)


@dataclass(frozen=True)
class Pdsch:
    """PDSCH processor for one (cell, grant, sf_idx, cfi, rnti) bucket."""

    cell: Cell
    grant: DlGrant
    sf_idx: int
    cfi: int = 1
    rnti: int = 0x1234
    # TDD special subframe: PDSCH maps only to the DwPTS symbols; pair with
    # grant.is_dwpts for the 0.75-scaled TBS (36.213 §7.1.7)
    dwpts_symbols: int | None = None

    def __post_init__(self):
        # extended-duration PHICH in symbols 1/2 would collide with PDSCH REs
        # mapped from a smaller control region
        if self.cell.phich_length == "ext" and self.cfi < 3:
            raise ValueError("extended PHICH duration requires CFI >= 3")
        if self.cell.nof_ports != 1:
            raise NotImplementedError(
                "PDSCH transmit diversity (2 and 4 ports) is not ported yet "
                "(ROADMAP queue A item 8: rest of DL)")

    @functools.cached_property
    def cfg(self) -> DlschConfig:
        return dlsch_config(self.cell, self.grant, self.sf_idx, self.cfi,
                            self.dwpts_symbols)

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        ps, pb = sf_flags(self.sf_idx)
        return pdsch_re_indices(self.cell, self.grant.prb_mask, self.cfi, ps, pb,
                                self.grant.prb_mask_slot1, self.dwpts_symbols)

    def _re_idx_t(self, device) -> torch.Tensor:
        return table(("pdsch_re", self), device, lambda: self.re_idx.astype(np.int64))

    @property
    def cinit(self) -> int:
        return pdsch_cinit(self.rnti, 0, self.sf_idx, self.cell.id)

    # -- eNB side -----------------------------------------------------------
    def encode(self, bits, grids, device=None):
        """bits [..., tbs] -> grids with PDSCH REs filled (a new tensor).

        grids: [..., nports, nsym_sf, nof_re] complex64 per-port RE grids.
        """
        grids = as_tensor(grids, device)
        bits = as_tensor(bits, grids.device)
        coded = dlsch_encode(bits, self.cfg)
        scr = scramble_bits(coded, self.cinit)
        sym = modulate(scr, self.grant.modulation)
        o = self.cell.ofdm
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        flat[..., 0, self._re_idx_t(grids.device)] = sym
        return flat.reshape(grids.shape)

    # -- UE side ------------------------------------------------------------
    def soft_bits(self, grid, ce, noise_var, device=None):
        """grid [..., nsym, nre], ce [..., nports, nsym, nre] -> descrambled
        LLRs [..., G] (positive => bit 1).

        Equalizes (zero forcing, 1 port), demodulates, weights each RE's LLRs
        by its post-equalization SNR and descrambles: what a HARQ soft buffer
        combines (`mac.harq.combine_llr`) and `decode` decodes.
        """
        grid = as_tensor(grid, device)
        ce = as_tensor(ce, grid.device)
        o = self.cell.ofdm
        idx = self._re_idx_t(grid.device)
        y = grid.reshape(grid.shape[:-2] + (o.nsymb_sf * o.nof_re,))[..., idx]
        cef = ce.reshape(ce.shape[:-2] + (o.nsymb_sf * o.nof_re,))
        nv = as_tensor(noise_var, grid.device, torch.float32)
        if nv.dim():
            nv = nv[..., None]  # broadcast over REs
        h = cef[..., 0, :][..., idx]
        xhat = equalize_zf(y, h)
        gain = torch.abs(h) ** 2  # per-RE reliability after ZF
        # weight LLRs by per-RE post-equalization SNR (max-log optimal scaling)
        w = gain / torch.clamp(nv, min=1e-9)
        llr = demod_soft(xhat, self.grant.modulation)
        qm = self.grant.modulation.bits_per_symbol
        llr = llr * torch.repeat_interleave(w, qm, dim=-1)
        return scramble_llr(llr, self.cinit)

    def decode(self, grid, ce, noise_var, n_iter: int = 5, device=None,
               siso_dtype: torch.dtype = torch.float32):
        """grid [..., nsym, nre], ce [..., nports, nsym, nre] -> (bits, crc_ok).

        `soft_bits`, then DL-SCH decoding (`siso_dtype`: the turbo decoder's
        working dtype, see `dlsch.dlsch_decode`).
        """
        llr = self.soft_bits(grid, ce, noise_var, device)
        return dlsch_decode(llr, self.cfg, n_iter=n_iter, siso_dtype=siso_dtype)
