# Frozen copy of srslte_tpu_torch/phy/chest/refsignal_dl.py at commit e4337f4, unchanged but for this line.
"""Cell-specific reference signals (CRS), 36.211 §6.10.1.

Reference behavior: lib/src/phy/ch_estimation/refsignal_dl.c: pilot values
r(m') with m' = m + MAX_PRB - nof_prb over a 2*MAX_PRB sequence per (slot,
symbol), QPSK from the Gold sequence with
c_init = 2^10*(7(ns+1)+l+1)*(2*NID+1) + 2*NID + N_cp (refsignal_dl.c:99),
frequency positions k = 6m + (v(port,l') + NID mod 6) mod 6.

All tables are host-precomputed numpy per (cell, sf_idx), uploaded once per
device and applied with gathers/scatters.
"""

from __future__ import annotations

import functools

import numpy as np

from ..._device import as_tensor, table
from ..common.params import CP, Cell
from ..common.sequence import gold_sequence

MAX_PRB = 110


def crs_nof_symbols_slot(port: int) -> int:
    """CRS symbols per slot: 2 for ports 0/1, 1 for ports 2/3."""
    return 2 if port < 2 else 1


def crs_symbol_l(ref_idx: int, port: int, cp: CP) -> int:
    """Slot-symbol index of the ref_idx-th CRS symbol for a port."""
    if port < 2:
        return 0 if ref_idx == 0 else cp.nsymb - 3
    return 1


def crs_v(port: int, ref_idx: int) -> int:
    """Frequency shift v per port and subframe-level CRS symbol index
    (refsignal_dl.c srsran_refsignal_cs_v; ref_idx counts CRS symbols within
    the subframe: 0..3 for ports 0/1, 0..1 for ports 2/3)."""
    if port == 0:
        return 0 if ref_idx % 2 == 0 else 3
    if port == 1:
        return 3 if ref_idx % 2 == 0 else 0
    if port == 2:
        return 0 if ref_idx == 0 else 3
    return 3 if ref_idx == 0 else 0


def crs_sf_symbols(cell: Cell, port: int) -> tuple[int, ...]:
    """Subframe-symbol indices carrying CRS for a port (both slots)."""
    nsym = cell.cp.nsymb
    per_slot = crs_nof_symbols_slot(port)
    out = []
    for slot in range(2):
        for r in range(per_slot):
            out.append(slot * nsym + crs_symbol_l(r, port, cell.cp))
    return tuple(out)


def crs_fidx(cell: Cell, port: int, ref_idx: int) -> np.ndarray:
    """Subcarrier indices of the 2*nof_prb pilots of one CRS symbol."""
    v = (crs_v(port, ref_idx) + cell.id % 6) % 6
    return (v + 6 * np.arange(2 * cell.n_prb)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _crs_seq(cell_id: int, cp_is_norm: bool, ns: int, l: int) -> np.ndarray:
    """Full-bandwidth CRS values for one (slot, symbol): [2*MAX_PRB] complex64."""
    n_cp = 1 if cp_is_norm else 0
    c_init = 1024 * (7 * (ns + 1) + l + 1) * (2 * cell_id + 1) + 2 * cell_id + n_cp
    c = gold_sequence(c_init, 4 * MAX_PRB).astype(np.float32)
    vals = (1 - 2 * c[0::2]) + 1j * (1 - 2 * c[1::2])
    return (vals / np.sqrt(2)).astype(np.complex64)


def crs_pilots(cell: Cell, sf_idx: int, port: int) -> np.ndarray:
    """Pilot values for one subframe/port: [n_crs_sym, 2*nof_prb] complex64."""
    per_slot = crs_nof_symbols_slot(port)
    rows = []
    for slot in range(2):
        ns = 2 * sf_idx + slot
        for r in range(per_slot):
            l = crs_symbol_l(r, port, cell.cp)
            full = _crs_seq(cell.id, cell.cp is CP.NORM, ns, l)
            m = np.arange(2 * cell.n_prb) + MAX_PRB - cell.n_prb
            rows.append(full[m])
    return np.stack(rows).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def crs_re_indices(cell: Cell, port: int) -> tuple[np.ndarray, np.ndarray]:
    """(sym_idx [S], k_idx [S, 2*nprb]) for the CRS REs of a port."""
    syms = np.asarray(crs_sf_symbols(cell, port), np.int32)
    ks = np.stack([crs_fidx(cell, port, r) for r in range(len(syms))])
    return syms, ks.astype(np.int32)


@functools.lru_cache(maxsize=None)
def crs_mask(cell: Cell) -> np.ndarray:
    """[nsym_sf, nof_re] bool: True where any configured port transmits CRS,
    including the paired v+3 shift reserved when 2+ ports are configured
    (36.211 §6.10.1.2: PDSCH rate-matches around all CRS REs).
    """
    o = cell.ofdm
    m = np.zeros((o.nsymb_sf, o.nof_re), bool)
    for port in range(cell.nof_ports):
        syms, ks = crs_re_indices(cell, port)
        for i, s in enumerate(syms):
            m[s, ks[i]] = True
            if cell.nof_ports > 1:
                base = ks[i] - ks[i] % 6  # 6m
                m[s, base + (ks[i] % 6 + 3) % 6] = True
    return m


def crs_index_tensors(cell: Cell, port: int, device):
    """(syms [S, 1], ks [S, 2*nprb]) int64 on the device: a broadcast pair."""
    syms, ks = crs_re_indices(cell, port)
    s = table(("crs_syms", cell, port), device,
              lambda: syms.astype(np.int64)[:, None])
    k = table(("crs_ks", cell, port), device, lambda: ks.astype(np.int64))
    return s, k


def crs_pilot_tensor(cell: Cell, sf_idx: int, port: int, device):
    return table(("crs_pilots", cell, sf_idx, port), device,
                 lambda: crs_pilots(cell, sf_idx, port))


def put_crs(grid, cell: Cell, sf_idx: int, port: int, device=None):
    """Insert CRS of one port into its per-port grid [..., nsym_sf, nof_re].

    Returns a new tensor; the argument is left as it was."""
    grid = as_tensor(grid, device).clone()
    syms, ks = crs_index_tensors(cell, port, grid.device)
    grid[..., syms, ks] = crs_pilot_tensor(cell, sf_idx, port, grid.device)
    return grid


def get_crs(grid, cell: Cell, port: int, device=None):
    """Extract received CRS REs: [..., n_crs_sym, 2*nof_prb]."""
    grid = as_tensor(grid, device)
    syms, ks = crs_index_tensors(cell, port, grid.device)
    return grid[..., syms, ks]
