"""Full DL chain sharded over TIME blocks with a chest halo exchange.

A multi-subframe receive stream is split into contiguous per-device blocks
of whole subframes; OFDM demod and PDSCH decode are local, but the channel
estimator's time-domain smoothing window spans the subframe BEFORE each
block's first subframe — that previous-subframe CRS estimate is copied from
the left neighbour's device (the JAX package's `ppermute`), the chest-stage
analog of the overlap-save halo the PSS search uses (halo.py), which
travels the other way.

The sharded chain is bit-exact with the unsharded one on fading channels:
both compute ce[i] = (ls[i] + ls[i-1]) / 2 with identical op order; only
where ls[i-1] comes from differs (local slice vs the halo).

Reference analog: ue_sync.c keeps one streaming context with state crossing
subframe boundaries; here that cross-boundary state is an explicit halo.
The chain's tables (scrambling, CRS) are host tables built as in the JAX
package; `convert.py` has nothing to carry for it.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from .._device import as_tensor, sequence, table
from ..phy.chest.refsignal_dl import crs_pilots, crs_re_indices
from ..phy.common.params import Cell
from ..phy.common.scrambling import pdsch_cinit
from ..phy.common.sequence import gold_sequence
from ..phy.modem.modem import demod_soft, modulate
from ..phy.ofdm import Ofdm
from ..phy.phch.dlsch import dlsch_decode, dlsch_encode
from ..phy.phch.pdsch import Pdsch
from ..phy.phch.ra import DlGrant

GEOMETRY_SF = 4  # plain data subframe (no PSS/SSS/PBCH) donates the RE map


def halo_from_left(lasts: list) -> list:
    """The chest halo: shard k receives shard k-1's last subframe estimate
    (it travels right, k -> k+1); shard 0's, from the last shard, is
    replaced by its own first subframe when it holds the stream's start."""
    n = len(lasts)
    return [lasts[(k - 1) % n] for k in range(n)]


@dataclass(frozen=True)
class TimeShardedDlChain:
    """Multi-subframe DL chain for one (cell, grant) bucket, single port.

    All subframes share the plain-subframe PDSCH geometry (subframe 4, CFI
    1); per-subframe state (scrambling sequence, CRS values) comes from
    host-precomputed [10, ...] tables indexed by sf mod 10, so every shard
    runs the same code at its own subframe offset.
    """

    cell: Cell
    grant: DlGrant
    rnti: int = 0x46

    def __post_init__(self):
        assert self.cell.nof_ports == 1

    @functools.cached_property
    def _pdsch(self) -> Pdsch:
        return Pdsch(self.cell, self.grant, GEOMETRY_SF, cfi=1, rnti=self.rnti)

    @functools.cached_property
    def _ofdm(self) -> Ofdm:
        return Ofdm(self.cell.ofdm, normalize=True)

    def _scr_table(self, device) -> torch.Tensor:
        """[10, G] scrambling bits per sf index (uint8)."""
        g = self._pdsch.cfg.G
        return sequence(("time_shard_scr", self.cell, self.rnti, g), device, lambda: np.stack([
            gold_sequence(pdsch_cinit(self.rnti, 0, sf, self.cell.id), g) for sf in range(10)]))

    def _crs(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(positions [n_pil], values [10, n_pil]) flat-grid CRS, port 0."""
        o = self.cell.ofdm

        def pos():
            syms, ks = crs_re_indices(self.cell, 0)
            return (syms[:, None] * o.nof_re + ks).reshape(-1).astype(np.int64)
        return (table(("time_shard_crs_pos", self.cell), device, pos),
                table(("time_shard_crs", self.cell), device, lambda: np.stack(
                    [crs_pilots(self.cell, sf, 0).reshape(-1) for sf in range(10)]
                ).astype(np.complex64)))

    @functools.cached_property
    def _interp_plan(self) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
        """(order of the merged combs, left, right [nof_re], weight t
        [nof_re] float32): linear interpolation from the sorted pilot
        subcarriers onto every subcarrier."""
        _, ks = crs_re_indices(self.cell, 0)
        all_ks = np.concatenate([ks[0], ks[1]])
        order = np.argsort(all_ks)
        sc = np.sort(all_ks)
        tgt = np.arange(self.cell.ofdm.nof_re)
        right = np.searchsorted(sc, tgt).clip(1, len(sc) - 1)
        left = right - 1
        t = ((tgt - sc[left]) / (sc[right] - sc[left])).astype(np.float32)
        return order.astype(np.int64), left.astype(np.int64), right.astype(np.int64), t

    @property
    def tbs(self) -> int:
        return self.grant.tbs

    @property
    def sf_len(self) -> int:
        return self.cell.ofdm.sf_len

    # -- eNB side -----------------------------------------------------------
    def encode(self, bits, sf0: int = 0, device=None):
        """bits [n_sf, tbs] -> samples [n_sf, sf_len] (sf indices sf0+i)."""
        bits = as_tensor(bits, device)
        dev = bits.device
        n_sf = bits.shape[0]
        o = self.cell.ofdm
        sfs = torch.as_tensor((np.arange(n_sf) + sf0) % 10, device=dev)
        coded = dlsch_encode(bits, self._pdsch.cfg)
        scr = coded.to(torch.uint8) ^ self._scr_table(dev)[sfs]
        sym = modulate(scr, self.grant.modulation)
        flat = torch.zeros((n_sf, o.nsymb_sf * o.nof_re), dtype=torch.complex64, device=dev)
        flat[:, self._pdsch._re_idx_t(dev)] = sym
        pos, vals = self._crs(dev)
        flat[:, pos] = vals[sfs]
        return self._ofdm.tx_sf(flat.reshape(n_sf, o.nsymb_sf, o.nof_re))

    # -- UE side ------------------------------------------------------------
    def _chain_from_ls(self, grids, ls_f, sf_mod, n_iter):
        """Common tail: the final CE in frequency per subframe, ls_f
        [n, nof_re] (time smoothing done by the caller) -> equalize +
        decode."""
        dev = grids.device
        idx = self._pdsch._re_idx_t(dev)
        k = table(("time_shard_re_sc", self.cell, self.grant), dev,
                  lambda: self._pdsch.re_idx.astype(np.int64) % self.cell.ofdm.nof_re)
        flat = grids.reshape(grids.shape[:-2] + (-1,))
        y = flat[..., idx]
        h = ls_f[..., k]  # every symbol of a subframe shares its CE
        xhat = y * torch.conj(h) / torch.clamp(torch.abs(h) ** 2, min=1e-12)
        llr = demod_soft(xhat, self.grant.modulation)
        qm = self.grant.modulation.bits_per_symbol
        llr = llr * torch.repeat_interleave(torch.abs(h) ** 2, qm, dim=-1)
        llr = llr * (1.0 - 2.0 * self._scr_table(dev).to(torch.float32)[sf_mod])
        return dlsch_decode(llr, self._pdsch.cfg, n_iter=n_iter)

    def _ls_freq(self, grids, sf_mod):
        """[n, nsym, nre] -> per-subframe frequency LS [n, nof_re]:
        average the CRS symbols per pilot SC, linear-interp across SCs."""
        dev = grids.device
        pos, vals = self._crs(dev)
        flat = grids.reshape(grids.shape[:-2] + (-1,))
        ls = flat[..., pos] * torch.conj(vals[sf_mod])
        n_sym = len(crs_re_indices(self.cell, 0)[0])
        ls_sym = ls.reshape(ls.shape[:-1] + (n_sym, ls.shape[-1] // n_sym))
        # two comb offsets alternate over CRS symbols: average same-offset
        # symbols, then merge both combs on the subcarrier axis
        merged = torch.cat([(ls_sym[..., 0, :] + ls_sym[..., 2, :]) / 2,
                            (ls_sym[..., 1, :] + ls_sym[..., 3, :]) / 2], -1)
        key = ("time_shard_interp", self.cell)
        order, left, right, t = (
            table((*key, i), dev, lambda i=i: self._interp_plan[i]) for i in range(4))
        h_sc = merged[..., order]
        return h_sc[..., left] * (1 - t) + h_sc[..., right] * t

    @staticmethod
    def _smooth(h_full, h_prev, first_is_global: bool):
        """ce[i] = (h[i] + h[i-1]) / 2; the block's first subframe uses
        `h_prev` (neighbour halo), or itself when globally first."""
        prev = torch.cat([(h_full[0] if first_is_global else h_prev)[None], h_full[:-1]], dim=0)
        return (h_full + prev) / 2

    def _sf_mod(self, n_sf: int, first: int, sf0: int, device) -> torch.Tensor:
        return torch.as_tensor((np.arange(n_sf) + first + sf0) % 10, device=device)

    def rx(self, samples, sf0: int = 0, n_iter: int = 5, device=None):
        """Unsharded reference: samples [n_sf, sf_len] -> (bits, ok)."""
        samples = as_tensor(samples, device)
        sf_mod = self._sf_mod(samples.shape[0], 0, sf0, samples.device)
        grids = self._ofdm.rx_sf(samples)
        h_full = self._ls_freq(grids, sf_mod)
        ce = self._smooth(h_full, h_full[0], True)
        return self._chain_from_ls(grids, ce, sf_mod, n_iter)

    def _sharded_ce(self, samples, mesh, axis: str, sf0: int):
        """Block k of the stream on the k-th device of `axis`: its grids,
        its smoothed CE (the first subframe's from the halo) and its
        subframe indices."""
        blocks = mesh.shards(as_tensor(samples, mesh.axis_devices(axis)[0]), axis)
        per = blocks[0].shape[0]
        sf_mods = [self._sf_mod(per, k * per, sf0, x.device) for k, x in enumerate(blocks)]
        grids = [self._ofdm.rx_sf(x) for x in blocks]
        h_full = [self._ls_freq(g, m) for g, m in zip(grids, sf_mods)]
        halos = halo_from_left([h[-1] for h in h_full])
        ces = [self._smooth(h, p.to(h.device), k == 0)
               for k, (h, p) in enumerate(zip(h_full, halos))]
        return grids, ces, sf_mods

    def ce_sharded(self, samples, mesh, axis: str = "t", sf0: int = 0):
        """The smoothed CE [n_sf, nof_re] that `rx_sharded` equalizes with,
        in subframe order on the first shard's device."""
        return mesh.gather(self._sharded_ce(samples, mesh, axis, sf0)[1], axis)

    def rx_sharded(self, samples, mesh, axis: str = "t", sf0: int = 0, n_iter: int = 5):
        """Time-sharded: the same computation, block k on the k-th device of
        `axis`, the chest halo copied from block k-1's device.  Returns
        (bits, ok) in subframe order on the first shard's device."""
        outs = [self._chain_from_ls(g, ce, m, n_iter)
                for g, ce, m in zip(*self._sharded_ce(samples, mesh, axis, sf0))]
        return (mesh.gather([o[0] for o in outs], axis), mesh.gather([o[1] for o in outs], axis))
