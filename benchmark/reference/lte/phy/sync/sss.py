# Frozen copy of srslte_tpu_torch/phy/sync/sss.py at commit e4337f4, unchanged but for this line.
"""SSS generation and detection (36.211 §6.11.2).

Reference behavior: lib/src/phy/sync/sss.c (sequence tables,
srsran_sss_generate) and find_sss.c (partial-correlation m0/m1 search).

Detection is two batched circulant products.  The even subcarriers,
descrambled by c0, correlate against all 31 cyclic shifts of s̃ at once
(one [31, 31] product per partial section, for robustness to residual
timing/CFO phase ramps); the winning shift selects the z̃ descrambler for the
odd part by a gather, then a second 31-shift correlation gives the other
index.  No early exit and no loop over hypotheses.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table, take

SSS_LEN = 62
N_SECTIONS = 4  # partial-correlation sections (find_sss.c style robustness)


def _lfsr31(taps: tuple[int, ...]) -> np.ndarray:
    """x(i+5) = sum_taps x(i+t) mod 2, x = (0,0,0,0,1); returns ±1 floats."""
    x = np.zeros(31, np.int64)
    x[4] = 1
    for i in range(26):
        x[i + 5] = sum(x[i + t] for t in taps) % 2
    return (1 - 2 * x).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _seqs():
    s = _lfsr31((2, 0))  # s̃: x(i+5)=x(i+2)+x(i)
    c = _lfsr31((3, 0))  # c̃: x(i+5)=x(i+3)+x(i)
    z = _lfsr31((4, 2, 1, 0))  # z̃: x(i+5)=x(i+4)+x(i+2)+x(i+1)+x(i)
    return s, c, z


def m0m1(n_id_1: int) -> tuple[int, int]:
    """36.211 table 6.11.2.1-1 generation rule."""
    qp = n_id_1 // 30
    q = (n_id_1 + qp * (qp + 1) // 2) // 30
    mp = n_id_1 + q * (q + 1) // 2
    m0 = mp % 31
    m1 = (m0 + mp // 31 + 1) % 31
    return m0, m1


@functools.lru_cache(maxsize=1)
def _nid1_table() -> np.ndarray:
    """[31, 31] int32: (m0, m1) -> N_id_1, -1 if invalid."""
    tbl = np.full((31, 31), -1, np.int32)
    for nid1 in range(168):
        m0, m1 = m0m1(nid1)
        tbl[m0, m1] = nid1
    return tbl


def sss_sequence(n_id_1: int, n_id_2: int, sf5: bool) -> np.ndarray:
    """SSS d(0..61) as ±1 float32 for subframe 0 (sf5=False) or 5 (sf5=True)."""
    s, c, z = _seqs()
    m0, m1 = m0m1(n_id_1)
    n = np.arange(31)
    s0 = s[(n + m0) % 31]
    s1 = s[(n + m1) % 31]
    c0 = c[(n + n_id_2) % 31]
    c1 = c[(n + n_id_2 + 3) % 31]
    z1_m0 = z[(n + (m0 % 8)) % 31]
    z1_m1 = z[(n + (m1 % 8)) % 31]
    d = np.empty(SSS_LEN, np.float32)
    if not sf5:
        d[0::2] = s0 * c0
        d[1::2] = s1 * c1 * z1_m0
    else:
        d[0::2] = s1 * c0
        d[1::2] = s0 * c1 * z1_m1
    return d


@functools.lru_cache(maxsize=None)
def _detect_tables(n_sections: int):
    """Precomputed tables for the product detector.

    S_sec [M, 31, 31]: section-masked cyclic-shift bank of s̃ (shift m, pos n).
    Z [8, 31]: z̃ shift bank (z1^(m) depends on m mod 8).
    C [3, 2, 31]: c0/c1 descramblers per N_id_2.
    """
    s, c, z = _seqs()
    n = np.arange(31)
    shifts = s[(n[None, :] + n[:, None]) % 31]  # [m, n]
    bounds = np.linspace(0, 31, n_sections + 1).astype(np.int64)
    masks = np.stack([(n >= bounds[i]) & (n < bounds[i + 1])
                      for i in range(n_sections)]).astype(np.float32)
    s_sec = masks[:, None, :] * shifts[None, :, :]
    zbank = np.stack([z[(n + m) % 31] for m in range(8)])
    cbank = np.stack([np.stack([c[(n + nid2) % 31], c[(n + nid2 + 3) % 31]])
                      for nid2 in range(3)])
    return (s_sec.astype(np.float32), zbank.astype(np.float32),
            cbank.astype(np.float32))


def _corr31(e, s_sec):
    """e [..., 31] complex -> partial-corr power [..., 31] over shifts."""
    t = torch.einsum("...n,kmn->...km", e, s_sec)
    return torch.sum(torch.abs(t) ** 2, dim=-2)


def sss_find(d, n_id_2, n_sections: int = N_SECTIONS, device=None):
    """Detect (N_id_1, sf5, metric) from received SSS subcarriers.

    d: [..., 62] complex (frequency-domain SSS REs, any common scaling).
    n_id_2: an int or an integer tensor of d's batch shape (selects the
    c0/c1 descrambler).  Returns (n_id_1 [...] int32, sf5 bool [...],
    metric [...]): the metric is the sum of the two winning
    partial-correlation powers normalized by ||d||^2; n_id_1 -1 marks an
    invalid (m0, m1) pair (noise-only windows).  Ties go to the first
    maximum, as in the JAX package.
    """
    d = as_tensor(d, device).to(torch.complex64)
    dev = d.device
    s_np, z_np, c_np = _detect_tables(n_sections)
    s_sec = table(("sss_s_sec", n_sections), dev, lambda: s_np, dtype=torch.complex64)
    zbank = table(("sss_zbank", n_sections), dev, lambda: z_np)
    cbank = table(("sss_cbank", n_sections), dev, lambda: c_np)
    c_sel = take(cbank, torch.as_tensor(n_id_2, device=dev).long())  # [..., 2, 31]

    even = d[..., 0::2] * c_sel[..., 0, :]
    odd = d[..., 1::2] * c_sel[..., 1, :]

    p_even = _corr31(even, s_sec)  # [..., 31]
    m_a = torch.argmax(p_even, dim=-1)
    z_row = take(zbank, m_a % 8)
    p_odd = _corr31(odd * z_row, s_sec)
    m_b = torch.argmax(p_odd, dim=-1)

    tbl = table(("sss_nid1",), dev, _nid1_table)
    nid1_sf0 = take(tbl.reshape(-1), m_a * tbl.shape[1] + m_b)
    nid1_sf5 = take(tbl.reshape(-1), m_b * tbl.shape[1] + m_a)
    sf5 = nid1_sf0 < 0
    n_id_1 = torch.where(sf5, nid1_sf5, nid1_sf0)

    energy = torch.sum(torch.abs(d) ** 2, dim=-1)
    metric = (torch.gather(p_even, -1, m_a[..., None])[..., 0]
              + torch.gather(p_odd, -1, m_b[..., None])[..., 0]) / torch.clamp(energy, min=1e-12)
    return n_id_1.to(torch.int32), sf5, metric
