# Frozen copy of srslte_tpu_torch/phy/phch/pdsch.py at commit e4337f4, unchanged but for this line.
"""PDSCH physical channel processor (36.211 §6.4, pdsch.c equivalent).

Reference behavior: lib/src/phy/phch/pdsch.c (srsran_pdsch_encode:1017,
srsran_pdsch_decode:788) and prb_dl.c RE mapping.  Encode: DL-SCH coding ->
scrambling -> modulation -> (layer map/precode) -> RE mapping.  Decode: RE
extraction -> equalize -> soft demod -> descramble -> DL-SCH decode.

The RE map (around CRS / control region / PBCH / sync, and the DwPTS end of a
TDD special subframe) is a static gather index per (cell, grant, sf class,
cfi) bucket, so a whole subframe's PDSCH moves with two gathers.  `Pdsch`
runs TM1 (1 port) and transmit diversity (2-port SFBC, 4-port SFBC-FSTD);
`PdschSm` 2-layer spatial multiplexing with two codewords (TM3 CDD, TM4
codebook) and `PdschSm4` 4 layers on 4 ports.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, sequence, table
from ...utils.jit import lazy_jit
from ..chest.refsignal_dl import crs_mask
from ..common.params import Cell
from ..common.scrambling import pdsch_cinit, scramble_bits
from ..common.sequence import gold_sequence_signed
from ..mimo.mimo import (diversity_combine, diversity_put, mmse_sm_2layer, mmse_sm_4port,
                         precode_sm_2layer, precode_sm_4port)
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
    # TDD special subframe: PDSCH maps only to the DwPTS symbols
    # (tdd.SPECIAL_SF_SYMBOLS[ss_config][0]); pair with grant.is_dwpts for
    # the 0.75-scaled TBS (36.213 §7.1.7)
    dwpts_symbols: int | None = None

    def __post_init__(self):
        # extended-duration PHICH in symbols 1/2 would collide with PDSCH REs
        # mapped from a smaller control region
        if self.cell.phich_length == "ext" and self.cfi < 3:
            raise ValueError("extended PHICH duration requires CFI >= 3")

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
        # keyed by what the RE map reads, so that every RNTI and mcs with
        # this allocation shares it
        key = ("pdsch_re", self.cell, self.grant.prb_mask, self.grant.prb_mask_slot1,
               self.cfi, sf_flags(self.sf_idx), self.dwpts_symbols)
        return table(key, device, lambda: self.re_idx.astype(np.int64))

    @property
    def cinit(self) -> int:
        return pdsch_cinit(self.rnti, 0, self.sf_idx, self.cell.id)

    @functools.cached_property
    def bucket(self) -> "Pdsch":
        """This processor without its RNTI: the key of its decoding graphs.
        The RNTI only seeds the scrambling sequence, which the graphs take
        as an input (`descrambling`), so every UE of a grant bucket replays
        one graph."""
        return dataclasses.replace(self, rnti=0)

    def descrambling(self, q: int, n: int, device) -> torch.Tensor:
        """Codeword q's scrambling sequence as +-1.0 [n] on the device."""
        seed = pdsch_cinit(self.rnti, q, self.sf_idx, self.cell.id)
        return sequence(("gold_signed", seed, n), device, lambda: gold_sequence_signed(seed, n))

    # -- eNB side -----------------------------------------------------------
    def encode(self, bits, grids, device=None):
        """bits [..., tbs] -> grids with PDSCH REs filled (a new tensor).

        grids: [..., nports, nsym_sf, nof_re] complex64 per-port RE grids.
        TM1 (1 port), SFBC (2 ports) or SFBC-FSTD (4 ports).
        """
        grids = as_tensor(grids, device)
        bits = as_tensor(bits, grids.device)
        coded = dlsch_encode(bits, self.cfg)
        scr = scramble_bits(coded, self.cinit)
        sym = modulate(scr, self.grant.modulation)
        o = self.cell.ofdm
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        diversity_put(flat, self._re_idx_t(grids.device), sym, self.cell.nof_ports)
        return flat.reshape(grids.shape)

    # -- UE side ------------------------------------------------------------
    def soft_bits(self, grid, ce, noise_var, device=None, scr=None):
        """grid [..., nsym, nre], ce [..., nports, nsym, nre] -> descrambled
        LLRs [..., G] (positive => bit 1).

        Equalizes (zero forcing for 1 port, SFBC combining for 2, SFBC-FSTD
        for 4), demodulates, weights each RE's LLRs by its post-equalization
        SNR and descrambles (by `scr`, default `descrambling(0, ...)`): what
        a HARQ soft buffer combines (`mac.harq.combine_llr`) and `decode`
        decodes.
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
        xhat, gain = diversity_combine(y, cef, idx, self.cell.nof_ports)
        # weight LLRs by per-RE post-equalization SNR (max-log optimal scaling)
        w = gain / torch.clamp(nv, min=1e-9)
        llr = demod_soft(xhat, self.grant.modulation)
        qm = self.grant.modulation.bits_per_symbol
        llr = llr * torch.repeat_interleave(w, qm, dim=-1)
        if scr is None:
            scr = self.descrambling(0, llr.shape[-1], llr.device)
        return llr * scr

    @lazy_jit(static_argnums=(0,), static_argnames=("n_iter",),
              bucket=lambda args, device: _by_bucket(args, device, 1))
    def decode(self, grid, ce, noise_var, n_iter: int = 5, device=None,
               siso_dtype: torch.dtype = torch.float32, scr=None):
        """grid [..., nsym, nre], ce [..., nports, nsym, nre] -> (bits, crc_ok).

        `soft_bits` (descrambled by `scr`, default this processor's
        sequence), then DL-SCH decoding (`siso_dtype`: the turbo decoder's
        working dtype, see `dlsch.dlsch_decode`).  On the card one graph
        per `bucket`: the sequence goes in as an input.
        """
        grid = as_tensor(grid, device)
        if scr is None:
            scr = self.descrambling(0, self.cfg.G, grid.device)
        llr = self.soft_bits(grid, ce, noise_var, scr=scr)
        return dlsch_decode(llr, self.cfg, n_iter, siso_dtype=siso_dtype)


def _by_bucket(args, device, codewords):
    """A graphed `decode` (1 codeword) or `decode2` (2) as its graph takes
    it: the processor's `bucket`, and its descrambling sequences as the
    `scr` input, so that every UE of a grant bucket replays one graph."""
    p = args["self"]
    if args["scr"] is None:
        args["scr"] = (p.descrambling(0, p.cfg.G, device) if codewords == 1
                       else p._scrs(None, device))
    args["self"] = p.bucket


def _weighted_llr(x, gain, nv, mod, scr):
    """Soft bits of one codeword's symbols x [..., n]: LLRs weighted by the
    per-RE post-MMSE gain over the scalar noise nv, descrambled by scr."""
    llr = demod_soft(x, mod)
    w = gain / torch.clamp(nv, min=1e-9)
    llr = llr * torch.repeat_interleave(w, mod.bits_per_symbol, dim=-1)
    return llr * scr


@dataclass(frozen=True)
class PdschSm(Pdsch):
    """PDSCH with 2-layer spatial multiplexing (TM3/TM4, 2 codewords).

    Reference behavior: pdsch.c 2-TB path + precoding.c CDD/PMI kernels.
    pmi=None selects TM3 large-delay CDD; pmi in {0,1,2} selects the 2-port
    codebook entry (TM4).  Requires cell.nof_ports == 2 and a 2-RX-antenna
    receiver.
    """

    pmi: int | None = None
    # Second-TB grant (same PRB set, its own MCS/RV) for per-TB link
    # adaptation as signaled by DCI 2/2A (dci.c tb[1]); None = same as TB0.
    grant1: DlGrant | None = None

    def __post_init__(self):
        if self.cell.nof_ports != 2:
            raise ValueError("2-layer SM needs 2 TX ports")
        if self.grant1 is not None and self.grant1.prb_mask != self.grant.prb_mask:
            raise ValueError("both TBs of a 2-layer grant share its PRBs")

    def cinit_q(self, q: int) -> int:
        return pdsch_cinit(self.rnti, q, self.sf_idx, self.cell.id)

    def cfg_q(self, q: int) -> DlschConfig:
        if q == 0 or self.grant1 is None:
            return self.cfg
        return dlsch_config(self.cell, self.grant1, self.sf_idx, self.cfi)

    def grant_q(self, q: int) -> DlGrant:
        return self.grant if (q == 0 or self.grant1 is None) else self.grant1

    def _layers(self, bits0, bits1, device):
        """Per codeword: DL-SCH coding, scrambling and modulation."""
        out = []
        for q, bits in enumerate((bits0, bits1)):
            coded = dlsch_encode(as_tensor(bits, device), self.cfg_q(q))
            scr = scramble_bits(coded, self.cinit_q(q))
            out.append(modulate(scr, self.grant_q(q).modulation))
        return out

    def _rx(self, grids_rx, ce, noise_var, device):
        """(y [..., nrx, n], h [..., nrx, ntx, n], scalar noise) at the PDSCH
        REs; the noise is the mean of every value given (the reference's
        one regularizer for the whole batch)."""
        grids_rx = as_tensor(grids_rx, device)
        ce = as_tensor(ce, grids_rx.device)
        idx = self._re_idx_t(grids_rx.device)
        y = grids_rx.reshape(grids_rx.shape[:-2] + (-1,))[..., idx]
        h = ce.reshape(ce.shape[:-2] + (-1,))[..., idx]
        nv = torch.mean(as_tensor(noise_var, grids_rx.device, torch.float32))
        return y, h, nv

    # -- eNB side -----------------------------------------------------------
    @lazy_jit(static_argnums=(0,))
    def encode2(self, bits0, bits1, grids, device=None):
        """Two transport blocks -> 2 layers -> 2 ports (a new tensor)."""
        grids = as_tensor(grids, device)
        x = torch.stack(self._layers(bits0, bits1, grids.device), dim=-2)  # [..., 2, n]
        ports = precode_sm_2layer(x, self.pmi)  # [..., 2, n]
        o = self.cell.ofdm
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        idx = self._re_idx_t(grids.device)
        for p in range(2):
            flat[..., p, idx] = ports[..., p, :]
        return flat.reshape(grids.shape)

    # -- UE side ------------------------------------------------------------
    def _scrs(self, scr, device):
        """The two codewords' descrambling sequences (`scr` if given)."""
        return scr or tuple(self.descrambling(q, self.cfg_q(q).G, device) for q in range(2))

    def soft_bits2(self, grids_rx, ce, noise_var, device=None, scr=None):
        """grids_rx [..., 2rx, nsym, nre], ce [..., 2rx, 2tx, nsym, nre] ->
        the two codewords' descrambled LLRs (MMSE detection, then each
        layer's LLRs weighted by its post-MMSE gain)."""
        y, h, nv = self._rx(grids_rx, ce, noise_var, device)
        scr = self._scrs(scr, y.device)
        xhat, gain = mmse_sm_2layer(y, h, nv[None], self.pmi)
        return tuple(_weighted_llr(xhat[..., q, :], gain[..., q, :], nv,
                                   self.grant_q(q).modulation, scr[q])
                     for q in range(2))

    @lazy_jit(static_argnums=(0,), static_argnames=("n_iter",),
              bucket=lambda args, device: _by_bucket(args, device, 2))
    def decode2(self, grids_rx, ce, noise_var, n_iter: int = 5, device=None,
                siso_dtype: torch.dtype = torch.float32, scr=None):
        """grids_rx [..., 2rx, nsym, nre], ce [..., 2rx, 2tx, nsym, nre] ->
        ((bits0, ok0), (bits1, ok1)); each codeword decodes as its own
        DL-SCH batch, as in the C library (`scr`: the two codewords'
        descrambling sequences, default this processor's)."""
        grids_rx = as_tensor(grids_rx, device)
        llrs = self.soft_bits2(grids_rx, ce, noise_var, scr=self._scrs(scr, grids_rx.device))
        return tuple(dlsch_decode(llr, self.cfg_q(q), n_iter, siso_dtype=siso_dtype)
                     for q, llr in enumerate(llrs))


@dataclass(frozen=True)
class PdschSm4(PdschSm):
    """PDSCH with 4-layer spatial multiplexing (4 TX ports, 2 codewords).

    Layer mapping per 36.211 table 6.3.3.2-1 (2 CW / 4 layers): codeword q
    feeds layers 2q and 2q+1 alternately, so each codeword carries
    2 * nof_re symbols.  pmi=None selects 4-port large-delay CDD (TM3-style
    rank 4); pmi in 0..15 the 36.211 Householder codebook entry (TM4).
    Beyond the C library's 2x2 ceiling (precoding.c srsran_precoding_cdd
    rejects 4 ports).
    """

    def __post_init__(self):
        if self.cell.nof_ports != 4:
            raise ValueError("4-layer SM needs 4 TX ports")
        if self.grant1 is not None and self.grant1.prb_mask != self.grant.prb_mask:
            raise ValueError("both TBs of a 4-layer grant share its PRBs")

    def cfg_q(self, q: int) -> DlschConfig:
        g = self.grant_q(q)
        n_re = nof_re_pdsch(self.cell, g, self.sf_idx, self.cfi)
        qm = g.modulation.bits_per_symbol
        return DlschConfig(tbs=g.tbs, G=2 * n_re * qm, Qm=qm, rv=g.rv)

    # -- eNB side -----------------------------------------------------------
    @lazy_jit(static_argnums=(0,))
    def encode2(self, bits0, bits1, grids, device=None):
        """Two transport blocks -> 4 layers -> 4 ports (a new tensor)."""
        grids = as_tensor(grids, device)
        layers = []
        for sym in self._layers(bits0, bits1, grids.device):  # [..., 2*n_re]
            layers += [sym[..., 0::2], sym[..., 1::2]]
        ports = precode_sm_4port(torch.stack(layers, dim=-2), self.pmi)  # [..., 4, n_re]
        o = self.cell.ofdm
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        idx = self._re_idx_t(grids.device)
        for p in range(4):
            flat[..., p, idx] = ports[..., p, :]
        return flat.reshape(grids.shape)

    # -- UE side ------------------------------------------------------------
    def soft_bits2(self, grids_rx, ce, noise_var, device=None, scr=None):
        """grids_rx [..., 4rx, nsym, nre], ce [..., 4rx, 4tx, nsym, nre] ->
        the two codewords' descrambled LLRs (4-layer MMSE, layers 2q and
        2q+1 de-mapped back into codeword q's symbol stream)."""
        y, h, nv = self._rx(grids_rx, ce, noise_var, device)
        scr = self._scrs(scr, y.device)
        xhat, gain = mmse_sm_4port(y, h, nv[None], self.pmi, n_layers=4)
        lead = xhat.shape[:-2]
        return tuple(
            _weighted_llr(xhat[..., 2 * q:2 * q + 2, :].transpose(-1, -2).reshape(lead + (-1,)),
                          gain[..., 2 * q:2 * q + 2, :].transpose(-1, -2).reshape(lead + (-1,)),
                          nv, self.grant_q(q).modulation, scr[q])
            for q in range(2))
