"""NR NZP-CSI-RS: mapping, generation and measurement (38.211 §7.4.1.5,
csi_rs.c equivalent).

Reference behavior: lib/src/phy/ch_estimation/csi_rs.c — resource-mapping
rows 1 (1 port, density 3: k0, k0+4, k0+8) and 2 (1 port, density 1/0.5),
frequency-domain-allocation bitmap -> k0, periodicity check
(srsran_csi_rs_send:229), per-symbol gold sequence skipped past
unallocated RBs, and the EPRE/RSRP/N0/SNR measurement accumulators
(srsran_csi_rs_nzp_measure:424).

Note: csi_rs.c:188 seeds the sequence with (...)(2 n_ID) << 10 + n_ID,
dropping the "+1" of 38.211 §7.4.1.5.2; this implementation follows the
spec's (2 n_ID + 1).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.sequence import gold_sequence
from .params import NRE, NSYMB_SLOT, NrCarrier


@dataclass(frozen=True)
class NzpCsiRs:
    """One NZP-CSI-RS resource (rows 1/2, single port)."""

    row: int = 1  # 1: density-3; 2: density-1
    freq_alloc: int = 0b0001  # bitmap (row 1: 4 bits, row 2: 12 bits)
    l0: int = 4  # first symbol
    scrambling_id: int = 0
    start_rb: int = 0
    nof_rb: int = 0  # 0 = whole carrier
    period: int = 0  # slots; 0 = aperiodic/always when asked
    offset: int = 0

    @property
    def density(self) -> int:
        return 3 if self.row == 1 else 1

    @property
    def k0(self) -> int:
        """First set bit of the allocation bitmap (csi_rs_location_f)."""
        nof = 4 if self.row == 1 else 12
        for j in range(nof):
            if (self.freq_alloc >> (nof - 1 - j)) & 1:
                return j
        raise ValueError("empty frequency-domain allocation")

    def k_list(self) -> tuple[int, ...]:
        if self.row == 1:
            return (self.k0, self.k0 + 4, self.k0 + 8)
        return (self.k0,)

    def send_in(self, slot: int) -> bool:
        if self.period == 0:
            return True
        return (slot + self.period - self.offset) % self.period == 0


def _rb_range(res: NzpCsiRs, carrier: NrCarrier) -> tuple[int, int]:
    rb0 = res.start_rb
    rb1 = carrier.n_prb if res.nof_rb == 0 else min(carrier.n_prb,
                                                    res.start_rb + res.nof_rb)
    return rb0, rb1


def _cinit(res: NzpCsiRs, slot: int, l: int) -> int:
    return ((1 << 10) * (NSYMB_SLOT * slot + l + 1)
            * (2 * res.scrambling_id + 1) + res.scrambling_id) % (1 << 31)


@functools.lru_cache(maxsize=None)
def _plan(res: NzpCsiRs, carrier: NrCarrier, slot: int):
    """(flat grid indices [n], pilot values [n])."""
    rb0, rb1 = _rb_range(res, carrier)
    ks = res.k_list()
    idx, vals = [], []
    c = gold_sequence(_cinit(res, slot, res.l0),
                      2 * res.density * rb1).astype(np.float32)
    r = ((1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])) / np.sqrt(2)
    # sequence index advances density-per-RB from RB 0 (sequence_state_advance)
    for n in range(rb0, rb1):
        for i, k in enumerate(ks):
            idx.append(res.l0 * carrier.nof_re + n * NRE + k)
            vals.append(r[res.density * n + i])
    return (np.array(idx, np.int32), np.array(vals, np.complex64))


def _plan_t(res: NzpCsiRs, carrier: NrCarrier, slot: int, device):
    key = ("csi_rs", res, carrier, slot)
    idx = table(key + ("idx",), device, lambda: _plan(res, carrier, slot)[0].astype(np.int64))
    vals = table(key + ("vals",), device, lambda: _plan(res, carrier, slot)[1])
    return idx, vals


def csi_rs_put(res: NzpCsiRs, carrier: NrCarrier, slot: int, grid, device=None):
    """Write the resource into a slot grid [..., NSYMB_SLOT, nof_re]."""
    grid = as_tensor(grid, device)
    if not res.send_in(slot):
        return grid
    idx, vals = _plan_t(res, carrier, slot, grid.device)
    flat = grid.reshape(grid.shape[:-2] + (-1,)).clone()
    flat[..., idx] = vals
    return flat.reshape(grid.shape)


def csi_rs_measure(res: NzpCsiRs, carrier: NrCarrier, slot: int, grid,
                   device=None) -> dict:
    """EPRE / RSRP / N0 / SNR from the received resource
    (srsran_csi_rs_nzp_measure semantics)."""
    grid = as_tensor(grid, device)
    idx, vals = _plan_t(res, carrier, slot, grid.device)
    flat = grid.reshape(grid.shape[:-2] + (-1,))
    y = flat[..., idx] * torch.conj(vals)
    epre = torch.mean(torch.abs(y) ** 2, dim=-1)
    rsrp_c = torch.mean(y, dim=-1)
    rsrp = torch.abs(rsrp_c) ** 2
    n0 = torch.clamp(epre - rsrp, min=1e-12)
    return {"epre": epre, "rsrp": rsrp, "n0": n0,
            "snr_db": 10.0 * torch.log10(rsrp / n0)}
