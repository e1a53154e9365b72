# Frozen copy of srslte_tpu_torch/phy/phch/pdcch.py at commit e4337f4, unchanged but for this line.
"""PDCCH encode + blind DCI search (36.211 §6.8, 36.213 §9.1.1).

Reference behavior: lib/src/phy/phch/pdcch.c: DCI CRC16 scrambled by RNTI
(dci_encode/dci_decode :335), K=7 tail-biting convolutional code, rate match
to 72*L bits, scrambling over the multiplexed control region (§6.8.2), QPSK,
REG interleaving (regs.py); search spaces per 36.213: common (L=4: CCEs
0/4/8/12; L=8: 0/8) and UE-specific via the Y_k hash recursion
(srsran_pdcch_ue_locations).

The C library's control-heavy early-exit candidate loop (ue_dl.c:645) becomes
ONE batched pipeline: all candidates gather, equalize, demodulate,
de-ratematch, Viterbi-decode and CRC-check together; hits are selected by
mask on the host.  1 port, 2-port SFBC or 4-port SFBC-FSTD.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, sequence
from ...utils.jit import lazy_jit
from ..common.params import Cell
from ..common.scrambling import pdcch_cinit
from ..common.sequence import gold_sequence, gold_sequence_signed
from ..fec.convolutional import conv_encode, rm_conv_rx, rm_conv_tx, viterbi_decode
from ..fec.crc import LTE_CRC16, crc_bits, crc_ok_device
from ..mimo.mimo import diversity_combine, diversity_put
from ..modem.modem import Modulation, demod_soft, modulate
from .regs import reg_layout

# UE-specific candidates per aggregation level L (36.213 table 9.1.1-1)
UE_CANDIDATES = {1: 6, 2: 6, 4: 2, 8: 2}
COMMON_CANDIDATES = {4: 4, 8: 2}


def rnti_mask(rnti: int) -> np.ndarray:
    return np.array([(rnti >> (15 - i)) & 1 for i in range(16)], np.uint8)


def rnti_mask_t(rnti: int, device) -> torch.Tensor:
    """`rnti_mask` on the device: a traced input of the decoders, so that
    every RNTI replays one graph."""
    return sequence(("rnti_mask", rnti), device, lambda: rnti_mask(rnti))


def yk(rnti: int, sf_idx: int) -> int:
    """36.213 §9.1.1 UE-specific search-space hash."""
    y = rnti
    for _ in range(sf_idx + 1):
        y = (39827 * y) % 65537
    return y


@dataclass(frozen=True)
class Location:
    cce: int
    L: int


def ue_locations(n_cce: int, rnti: int, sf_idx: int) -> list[Location]:
    locs = []
    for L, m_max in UE_CANDIDATES.items():
        if n_cce < L:
            continue
        y = yk(rnti, sf_idx)
        for m in range(m_max):
            cce = L * ((y + m) % (n_cce // L))
            loc = Location(cce, L)
            if loc not in locs:
                locs.append(loc)
    return locs


def common_locations(n_cce: int) -> list[Location]:
    locs = []
    for L, m_max in COMMON_CANDIDATES.items():
        for m in range(m_max):
            cce = m * L
            if cce + L <= min(n_cce, 16):
                locs.append(Location(cce, L))
    return locs


@dataclass(frozen=True)
class Pdcch:
    cell: Cell
    cfi: int
    sf_idx: int

    def __post_init__(self):
        # extended PHICH duration occupies symbols 0..2: the control region
        # must span them or PHICH/PDSCH REs collide (36.211 table 6.9.3-1)
        if self.cell.phich_length == "ext" and self.cfi < 3:
            raise ValueError("extended PHICH duration requires CFI >= 3")

    @functools.cached_property
    def re_idx(self) -> np.ndarray:
        """Flat grid indices in quadruplet-sequence order [n_cce*36]."""
        return reg_layout(self.cell).pdcch_re[self.cfi]

    @property
    def n_cce(self) -> int:
        return reg_layout(self.cell).n_cce[self.cfi]

    @functools.cached_property
    def _scramble_bits(self) -> np.ndarray:
        return gold_sequence(pdcch_cinit(self.sf_idx, self.cell.id),
                             self.n_cce * 72)

    @functools.cached_property
    def _scramble_signed(self) -> np.ndarray:
        return gold_sequence_signed(pdcch_cinit(self.sf_idx, self.cell.id),
                                    self.n_cce * 72)

    # -- eNB side -------------------------------------------------------------
    def encode(self, grids, payload: np.ndarray, rnti: int, loc: Location,
               device=None):
        """Encode one DCI at a location (a new tensor). payload: host uint8 bits [K]."""
        grids = as_tensor(grids, device)
        dev = grids.device
        payload = np.asarray(payload, np.uint8)
        K = len(payload)
        e = 72 * loc.L
        crc = crc_bits(payload, *LTE_CRC16) ^ rnti_mask(rnti)
        msg = as_tensor(np.concatenate([payload, crc]), dev)
        coded = rm_conv_tx(conv_encode(msg, K + 16), e)
        scr = coded ^ as_tensor(self._scramble_bits[loc.cce * 72 : loc.cce * 72 + e], dev)
        sym = modulate(scr, Modulation.QPSK)  # [36L]
        o = self.cell.ofdm
        idx = as_tensor(self.re_idx[loc.cce * 36 : (loc.cce + loc.L) * 36].astype(np.int64), dev)
        flat = grids.reshape(grids.shape[:-2] + (o.nsymb_sf * o.nof_re,)).clone()
        diversity_put(flat, idx, sym, self.cell.nof_ports)
        return flat.reshape(grids.shape)

    # -- UE side --------------------------------------------------------------
    def _llrs(self, grid, ce, locs):
        """Gather+equalize+demod all candidates of equal L: [..., ncand, 72L].

        grid [..., nsym, nre], ce [..., nports, nsym, nre]: leading batch
        dims (e.g. subframes) are supported so the whole batch's candidates
        feed ONE Viterbi kernel launch."""
        locs = tuple(locs)
        L = locs[0].L
        o = self.cell.ofdm
        dev = grid.device
        # a UE-specific search space follows from the RNTI: per-UE tables
        idx = sequence(("pdcch_re", self.cell, self.cfi, locs), dev, lambda: np.stack(
            [self.re_idx[l.cce * 36 : (l.cce + L) * 36] for l in locs]).astype(np.int64))
        y = grid.reshape(grid.shape[:-2] + (-1,))[..., idx]  # [..., ncand, 36L]
        cef = ce.reshape(ce.shape[:-3] + (ce.shape[-3], o.nsymb_sf * o.nof_re))
        xhat = diversity_combine(y, cef, idx, self.cell.nof_ports)[0]
        llr = demod_soft(xhat, Modulation.QPSK)  # [..., ncand, 72L]
        soff = sequence(("pdcch_scr", self.cell, self.cfi, self.sf_idx, locs), dev, lambda: np.stack(
            [self._scramble_signed[l.cce * 72 : (l.cce + L) * 72] for l in locs]))
        return llr * soff

    @lazy_jit(static_argnums=(0, 3, 4, 5))
    def decode_candidates(self, grid, ce, locs, payload_len: int, rnti: int,
                          device=None):
        """Blind-decode candidates (all of one L): -> (ok [..., ncand],
        bits [..., ncand, K])."""
        grid = as_tensor(grid, device)
        return self._decode_mixed_traced(grid, ce, (tuple(locs),), payload_len,
                                         rnti_mask_t(rnti, grid.device))

    @lazy_jit(static_argnums=(0, 3, 4))
    def _decode_mixed_traced(self, grid, ce, locs_by_L: tuple,
                             payload_len: int, rnti_mask_arr, device=None):
        """Blind-decode candidates at MIXED aggregation levels in one shot.

        locs_by_L: tuple of per-L tuples.  All candidates de-rate-match to
        the same 3*(payload+16) coded length, so a single Viterbi batch
        covers every aggregation level.  Returns (ok [..., ncand_total],
        bits [..., ncand_total, payload_len]) in the concatenated candidate
        order.
        """
        grid = as_tensor(grid, device)
        ce = as_tensor(ce, grid.device)
        n_coded = 3 * (payload_len + 16)
        derms = [rm_conv_rx(self._llrs(grid, ce, group), n_coded)
                 for group in locs_by_L if group]
        de_rm = torch.cat(derms, dim=-2)
        bits = viterbi_decode(de_rm.reshape(-1, n_coded), payload_len + 16)
        bits = bits.reshape(de_rm.shape[:-1] + (payload_len + 16,))
        ok = crc_ok_device(bits, *LTE_CRC16, rnti_mask=rnti_mask_arr)
        return ok, bits[..., :payload_len]

    def all_locations(self, Ls=(4, 8)) -> tuple:
        """Every aligned candidate at the given aggregation levels."""
        locs = []
        for L in Ls:
            locs.extend(Location(c, L) for c in range(0, self.n_cce - L + 1, L))
        return tuple(locs)

    def search_all(self, grid, ce, rnti: int, payload_len: int, Ls=(4, 8),
                   device=None):
        """Blind search of one subframe over ALL aligned candidates at the
        levels Ls: list of (Location, payload bits np[K])."""
        locs = self.all_locations(Ls)
        groups = tuple(tuple(l for l in locs if l.L == L) for L in Ls)
        return self._hits(grid, ce, groups, rnti, payload_len, device)

    def _hits(self, grid, ce, groups, rnti, payload_len, device):
        """One pass over the candidate groups; the hits on the host."""
        flat = [l for g in groups for l in g]
        if not flat:
            return []
        grid = as_tensor(grid, device)
        ok, bits = self._decode_mixed_traced(grid, ce, groups, payload_len,
                                             rnti_mask_t(rnti, grid.device))
        ok = ok.cpu().numpy()
        bits = bits.cpu().numpy()
        return [(l, bits[i]) for i, l in enumerate(flat) if ok[i]]

    def search(self, grid, ce, rnti: int, payload_len: int,
               include_common: bool = True, device=None):
        """Full blind search of one subframe: list of (Location, payload bits np[K]).

        One device dispatch for all aggregation levels.
        """
        locs = ue_locations(self.n_cce, rnti, self.sf_idx)
        if include_common:
            for l in common_locations(self.n_cce):
                if l not in locs:
                    locs.append(l)
        groups = tuple(tuple(l for l in locs if l.L == L)
                       for L in sorted({l.L for l in locs}))
        return self._hits(grid, ce, groups, rnti, payload_len, device)
