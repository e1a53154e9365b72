"""SRS: sounding reference signal (36.211 §5.5.3, refsignal_ul.c SRS parts).

Reference behavior: lib/src/phy/ch_estimation/refsignal_ul.c
(srsran_refsignal_srs_gen) — base sequence r_u,v with cyclic shift
alpha = 2*pi*n_srs/8, transmission comb k_TC (every 2nd subcarrier), last
SC-FDMA symbol of the subframe.

The C_srs/B_srs bandwidth-configuration tables (36.211 tables 5.5.3.2-1..4,
refsignal_ul.c m_srs_b/Nb, shipped as srs_bw.npz via
tools/extract_srs_tables.py) derive m_srs and the frequency position k0
from (bw_cfg, B, n_rrc) — srs_bandwidth()/srs_k0_prb() below mirror
srsran_refsignal_srs_M_sc / srs_k0_ue.  Frequency hopping over time follows
36.211 §5.5.3.2: for tree levels b > b_hop the position index n_b gets the
Fb(n_SRS) offset (refsignal_ul.c srs_Fb :781, srs_k0_ue :804) with the
SRS period T_SRS from 36.213 table 8.2-1 (T_srs_table :559).

The tables and the sequence are host numpy (config time); `Srs.encode` and
`Srs.estimate` are one scatter and one gather of the comb on the device.
This package keeps its own copy of `srs_bw.npz`.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..chest.refsignal_ul import base_sequence
from ..common.params import Cell

_SRS_BW_NPZ = os.path.join(os.path.dirname(__file__), "srs_bw.npz")


@functools.lru_cache(maxsize=1)
def _bw_tables():
    d = np.load(_SRS_BW_NPZ)
    return d["m_srs"].astype(int), d["nb"].astype(int)


def _bw_row(n_prb: int) -> int:
    """Which of tables 5.5.3.2-1..4 applies (srsbwtable_idx)."""
    if n_prb <= 40:
        return 0
    if n_prb <= 60:
        return 1
    if n_prb <= 80:
        return 2
    return 3


def srs_bandwidth(n_prb: int, b_srs: int, bw_cfg: int) -> int:
    """m_srs,b in PRB for (cell BW, B_srs, C_srs)."""
    return int(_bw_tables()[0][_bw_row(n_prb)][b_srs][bw_cfg])


def t_srs(i_srs: int) -> int:
    """SRS periodicity T_SRS in ms from I_SRS (36.213 table 8.2-1)."""
    for bound, t in ((2, 2), (7, 5), (17, 10), (37, 20), (77, 40),
                     (157, 80), (317, 160), (637, 320)):
        if i_srs < bound:
            return t
    return 0


def srs_toffset(i_srs: int) -> int:
    """SRS subframe offset from I_SRS (36.213 table 8.2-1)."""
    for bound in (2, 7, 17, 37, 77, 157, 317, 637):
        if i_srs < bound:
            return i_srs - {2: 0, 7: 2, 17: 7, 37: 17, 77: 37, 157: 77,
                            317: 157, 637: 317}[bound]
    return 0


def srs_send_tti(i_srs: int, tti: int) -> bool:
    """Whether this UE sounds in this tti (srsran_refsignal_srs_send_ue)."""
    t = t_srs(i_srs)
    return t > 0 and (tti - srs_toffset(i_srs)) % t == 0


def srs_fb(n_prb: int, b: int, bw_cfg: int, b_hop: int, i_srs: int,
           tti: int) -> int:
    """Frequency-hopping offset Fb for tree level b (36.211 §5.5.3.2,
    refsignal_ul.c srs_Fb)."""
    t = t_srs(i_srs)
    if t == 0:
        return 0
    n_srs = tti // t
    _, nb_tab = _bw_tables()
    row = _bw_row(n_prb)
    n_b = int(nb_tab[row][b][bw_cfg])
    prod_1 = 1
    for bp in range(b_hop + 1, b):
        prod_1 *= int(nb_tab[row][bp][bw_cfg])
    prod_2 = prod_1 * n_b
    if n_b % 2 == 0:
        return (n_b // 2) * ((n_srs % prod_2) // prod_1) \
            + (n_srs % prod_2) // prod_1 // 2
    return (n_b // 2) * (n_srs // prod_1)


def srs_k0_prb(n_prb: int, b_srs: int, bw_cfg: int, n_rrc: int,
               b_hop: int = 4, i_srs: int = 0, tti: int = 0) -> int:
    """UE SRS starting PRB (srs_k0_ue).

    The cell-specific region is centered in the band
    (srsran_refsignal_srs_rb_start_cs).  Tree levels b <= b_hop take the
    static RRC position nb = 4 n_rrc/m_srs % Nb; levels above it hop over
    time with the Fb(n_SRS) offset.  The default b_hop=4 disables hopping
    (b_hop >= B_srs).
    """
    m_tab, nb_tab = _bw_tables()
    row = _bw_row(n_prb)
    k0 = n_prb // 2 - m_tab[row][0][bw_cfg] // 2
    for b in range(b_srs + 1):
        m_b = int(m_tab[row][b][bw_cfg])
        nb = 4 * n_rrc // m_b
        if b > b_hop:
            nb += srs_fb(n_prb, b, bw_cfg, b_hop, i_srs, tti)
        k0 += m_b * (nb % int(nb_tab[row][b][bw_cfg]))
    return k0


def srs_config_from_bw(n_prb: int, bw_cfg: int, b_srs: int, n_rrc: int,
                       comb: int = 0, n_srs_cs: int = 0, b_hop: int = 4,
                       i_srs: int = 0, tti: int = 0) -> "SrsConfig":
    """Build an SrsConfig from the 36.211 bandwidth-configuration plane.

    With b_hop < b_srs the position follows the Fb frequency-hopping
    pattern for this tti (one static config per hop position — the caller
    keys its Srs cache on k0_prb like the reference pregenerates per-sf
    waveforms, refsignal_ul.c srsran_refsignal_srs_pregen)."""
    return SrsConfig(m_srs=srs_bandwidth(n_prb, b_srs, bw_cfg),
                     k0_prb=srs_k0_prb(n_prb, b_srs, bw_cfg, n_rrc,
                                       b_hop=b_hop, i_srs=i_srs, tti=tti),
                     comb=comb, n_srs_cs=n_srs_cs)


@dataclass(frozen=True)
class SrsConfig:
    m_srs: int  # sounding bandwidth in PRB (must be even, >= 4)
    k0_prb: int = 0  # starting PRB of the sounding region
    comb: int = 0  # k_TC in {0, 1}
    n_srs_cs: int = 0  # cyclic shift 0..7

    @property
    def m_sc(self) -> int:
        return self.m_srs * 12 // 2  # comb-2: half the subcarriers


@dataclass(frozen=True)
class Srs:
    cell: Cell
    cfg: SrsConfig

    @functools.cached_property
    def seq(self) -> np.ndarray:
        u = self.cell.id % 30
        alpha = 2 * np.pi * self.cfg.n_srs_cs / 8
        n = np.arange(self.cfg.m_sc)
        # base sequence length is m_sc (=m_srs/2 PRB worth of REs)
        r = base_sequence(u, 0, self.cfg.m_srs // 2)
        return (r * np.exp(1j * alpha * n)).astype(np.complex64)

    @functools.cached_property
    def k_idx(self) -> np.ndarray:
        k0 = self.cfg.k0_prb * 12 + self.cfg.comb
        return (k0 + 2 * np.arange(self.cfg.m_sc)).astype(np.int32)

    def _tables(self, device):
        k = table(("srs_k", self), device, lambda: self.k_idx.astype(np.int64))
        return k, table(("srs_seq", self), device, lambda: self.seq)

    def encode(self, grid, device=None):
        """Place SRS in the last symbol of grid [..., nsymb_sf, nof_re] (a new
        tensor)."""
        grid = as_tensor(grid, device).to(torch.complex64).clone()
        k, seq = self._tables(grid.device)
        grid[..., -1, k] = seq
        return grid

    def estimate(self, grid, device=None):
        """-> (h [..., m_sc] channel at the comb, noise [...], power [...])."""
        grid = as_tensor(grid, device)
        k, seq = self._tables(grid.device)
        h = grid[..., -1, k] * torch.conj(seq)
        # neighbor-difference noise estimate
        d = h[..., 1:] - h[..., :-1]
        noise = torch.mean(torch.abs(d) ** 2, dim=-1) / 2
        power = torch.mean(torch.abs(h) ** 2, dim=-1)
        return h, noise, power
