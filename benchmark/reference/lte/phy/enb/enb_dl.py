# Frozen copy of srslte_tpu_torch/phy/enb/enb_dl.py at commit e4337f4, unchanged but for this line.
"""eNB downlink subframe composition (enb_dl.c equivalent).

Reference behavior: lib/src/phy/enb/enb_dl.c: put_base (CRS/PSS/SSS/PCFICH/
PHICH, :344), put_pdcch (:372), put_pdsch (:404), gen_signal IFFT (:420).
Per-port RE grids (1, 2 or 4 ports) are composed functionally (every `put_*`
returns a new tensor) and modulated by the batched OFDM modulator.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, resolve
from ..chest.refsignal_dl import put_crs
from ..common.params import Cell
from ..common.zc import pss_sequence
from ..ofdm import Ofdm
from ..phch.pbch import Mib, Pbch
from ..phch.pcfich import Pcfich
from ..phch.pdcch import Location, Pdcch
from ..phch.pdsch import Pdsch
from ..phch.phich import Phich
from ..sync.sss import sss_sequence


@dataclass(frozen=True)
class EnbDl:
    cell: Cell

    @functools.cached_property
    def ofdm(self) -> Ofdm:
        return Ofdm(self.cell.ofdm, normalize=True)

    def empty_grids(self, batch=(), device=None):
        o = self.cell.ofdm
        return torch.zeros(tuple(batch) + (self.cell.nof_ports, o.nsymb_sf, o.nof_re),
                           dtype=torch.complex64, device=resolve(device))

    def put_pss_sss(self, grids, sf_idx: int, device=None):
        """PSS + SSS per the cell's frame structure (36.211 §6.11).

        FDD (type 1): PSS in the last symbol of slot 0, SSS one symbol
        earlier, subframes 0 and 5.  TDD (type 2): SSS in the LAST symbol
        of subframes 0 and 5, PSS in the THIRD symbol of subframes 1 and 6
        (the DwPTS).  Center 62 subcarriers around DC, port 0 (enb_dl.c:344
        put_base places them once, not per port).
        """
        grids = as_tensor(grids, device)
        o = self.cell.ofdm
        mid = o.nof_re // 2
        cell = self.cell

        def put(l, seq):
            out = grids.clone()
            out[..., 0, l, mid - 31 : mid + 31] = as_tensor(
                np.asarray(seq).astype(np.complex64), grids.device)
            return out

        if cell.frame_type == "tdd":
            if sf_idx % 5 == 0:
                return put(o.nsymb_sf - 1,
                           sss_sequence(cell.n_id_1, cell.n_id_2, sf5=(sf_idx == 5)))
            if sf_idx % 5 == 1:
                return put(2, pss_sequence(cell.n_id_2))
            return grids
        if sf_idx % 5 != 0:
            return grids
        grids = put(o.nsymb_slot - 1, pss_sequence(cell.n_id_2))
        return put(o.nsymb_slot - 2,
                   sss_sequence(cell.n_id_1, cell.n_id_2, sf5=(sf_idx == 5)))

    def put_base(self, grids, sf_idx: int, device=None):
        """CRS for all ports + PSS/SSS."""
        grids = as_tensor(grids, device).clone()
        for p in range(self.cell.nof_ports):
            grids[..., p, :, :] = put_crs(grids[..., p, :, :], self.cell, sf_idx, p)
        return self.put_pss_sss(grids, sf_idx)

    def put_pbch(self, grids, mib: Mib, device=None):
        """PBCH burst for frame phase mib.sfn%4 (subframe-0 grids only)."""
        return Pbch(self.cell).encode_frame(mib, grids, device)

    def put_pcfich(self, grids, sf_idx: int, cfi: int, device=None):
        return Pcfich(self.cell, sf_idx).encode(grids, cfi, device)

    def put_phich(self, grids, sf_idx: int, ack, device=None):
        """HI values ack [..., ngroups, 8] in {-1: off, 0: NACK, 1: ACK}."""
        return Phich(self.cell, sf_idx).encode(grids, ack, device)

    def put_pdcch(self, grids, sf_idx: int, cfi: int, payload, rnti: int,
                  loc: Location, device=None):
        return Pdcch(self.cell, cfi, sf_idx).encode(grids, payload, rnti, loc, device)

    def put_pdsch(self, grids, pdsch: Pdsch, bits, device=None):
        return pdsch.encode(bits, grids, device)

    def gen_signal(self, grids, device=None):
        """grids [..., nports, nsym, nre] -> samples [..., nports, sf_len]."""
        return self.ofdm.tx_sf(grids, device)
