"""Sharded multi-carrier DL pipeline (the cc_worker axis on a mesh).

Reference analog: each sf_worker loops one cc_worker per component carrier
(srsue sf_worker.cc:185-200); carriers are independent.  Here the carrier
axis is a leading dimension split over the mesh: each shard runs the full
per-carrier chain on its device, and only the flags cross back, to one
global BLER.  Subframe pipelining is the n_sf batch axis — ordering is by
construction (no tti_semaphore).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from .._device import as_tensor
from ..phy.common.params import Cell
from ..phy.enb.enb_dl import EnbDl
from ..phy.phch.pdsch import Pdsch
from ..phy.phch.ra import DlGrant
from ..phy.ue.ue_dl import UeDl


@dataclass(frozen=True)
class ShardedDlPipeline:
    """Full eNB->UE DL chain for one (cell, grant) bucket over a mesh."""

    cell: Cell
    grant: DlGrant
    sf_idx: int = 4
    rnti: int = 0x46

    @functools.cached_property
    def _pdsch(self) -> Pdsch:
        return Pdsch(self.cell, self.grant, self.sf_idx, rnti=self.rnti)

    @functools.cached_property
    def _enb(self) -> EnbDl:
        return EnbDl(self.cell)

    @functools.cached_property
    def _ue(self) -> UeDl:
        return UeDl(self.cell)

    @property
    def tbs(self) -> int:
        return self.grant.tbs

    def encode(self, bits, device=None):
        """bits [..., tbs] -> time samples [..., nports, sf_len] on the bits' device."""
        bits = as_tensor(bits, device)
        g = self._enb.put_base(self._enb.empty_grids(bits.shape[:-1], device=bits.device),
                               self.sf_idx)
        g = self._enb.put_pdsch(g, self._pdsch, bits)
        return self._enb.gen_signal(g)

    def decode(self, samples, n_iter: int = 5, device=None):
        """samples [..., sf_len] (1-port combined) -> (bits, ok, bler)."""
        bits, ok, _ = self._ue.decode_pdsch(samples, self._pdsch, n_iter=n_iter, device=device)
        return bits, ok, 1.0 - torch.mean(ok.to(torch.float32))

    def e2e(self, bits, n_iter: int = 5, device=None):
        s = self.encode(bits, device)
        rx = s[..., 0, :] if self.cell.nof_ports == 1 else s.sum(dim=-2)
        return self.decode(rx, n_iter=n_iter)

    def jit_e2e(self, mesh, axis: str = "carrier"):
        """The e2e step with the carrier axis (the leading one) split over
        the devices of `axis`: step(bits [n_carriers, ...]) -> (bits, ok in
        carrier order and the BLER over every carrier, on the first shard's
        device).  The name is the JAX package's; nothing is compiled."""
        def step(bits, n_iter: int = 5):
            parts = [self.e2e(b, n_iter=n_iter)[:2] for b in mesh.shards(
                as_tensor(bits, mesh.axis_devices(axis)[0]), axis)]
            out = mesh.gather([p[0] for p in parts], axis)
            ok = mesh.gather([p[1] for p in parts], axis)
            return out, ok, 1.0 - torch.mean(ok.to(torch.float32))
        return step
