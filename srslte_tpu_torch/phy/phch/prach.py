"""PRACH: random-access preamble generation and detection (36.211 §5.7).

Reference behavior: lib/src/phy/phch/prach.c — ZC root sequences of length
839 (formats 0-3), cyclic shifts from the zeroCorrelationZoneConfig N_cs
table, baseband generation via freq-domain mapping at 1.25 kHz spacing
(srsran_prach_gen:359), detection by freq-domain correlation against each
root + IFFT peak search over shift regions (srsran_prach_detect:702,
corr :467).

Detection correlates against ALL configured roots at once (one
[nroots, 839] multiply + batched IFFT) and scores every cyclic-shift region
with a segment-max — no per-root/per-shift loops.  Generation and the tables
are host numpy; `prach_detect` runs on the device, its FFTs through
`torch.fft` (cuFFT; the 839-point IFFT is a prime length).  Root sequence indices are
LOGICAL (36.211 table 5.7.2-4, shipped as prach_roots.npz — see
tools/extract_prach_roots.py; this package keeps its own copy).

Restricted sets (high-speed cells, 36.211 §5.7.2 / prach.c
srsran_prach_gen_seqs:392-425): the allowed cyclic shifts per root are the
N_shift/d_start/N_group/N_neg algebra over d_u (the cyclic Doppler distance
of the root), and detection additionally searches the +-d_u alias windows
where a Doppler-shifted preamble's peak lands.  Here the whole 64-preamble
set is one host-precomputed (root, C_v, d_u) table driving a uniform
[64, n_windows, N_cs] lag gather — the reference loops root-by-root and
window-by-window.  Unlike the reference (which reuses stale shift counts
when a root admits no shifts), roots with N_shift == 0 are skipped per the
spec.

Format 4 (TDD UpPTS short preamble): N_zc = 139, 7.5 kHz RA spacing,
phi = 2, its own N_cs table (5.7.2-3) and logical root order (5.7.2-5,
prach_tables.h prach_zc_roots_format4) — same generation/detection code
path, different constants.  (The reference reuses phi = 7 for format 4;
here the spec value 2 is used — self-consistent between gen and detect.)
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import OfdmParams
from ..common.zc import zadoff_chu

_ROOTS_NPZ = os.path.join(os.path.dirname(__file__), "prach_roots.npz")


@functools.lru_cache(maxsize=2)
def logical_roots(short: bool = False) -> np.ndarray:
    """36.211 tables 5.7.2-4/-5: logical index -> physical root u."""
    return np.load(_ROOTS_NPZ)["short" if short else "long"].astype(np.int64)

NZC = 839  # formats 0-3
NZC_SHORT = 139  # format 4
DELTA_F_RA = 1250  # Hz, formats 0-3
DELTA_F_RA_4 = 7500  # Hz, format 4
PHI = 7  # formats 0-3 (36.211 §5.7.3; format 4 uses phi = 2)
# T_cp and T_seq in units of Ts = 1/30.72e6 (36.211 table 5.7.1-1)
FORMAT_CP = {0: 3168, 1: 21024, 2: 6240, 3: 21024, 4: 448}
FORMAT_SEQ = {0: 24576, 1: 24576, 2: 2 * 24576, 3: 2 * 24576, 4: 4096}

# N_cs sets (36.211 tables 5.7.2-2/-3; prach_tables.h)
NCS_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419)
NCS_RESTRICTED = (15, 18, 22, 26, 32, 38, 46, 55, 68, 82, 100, 128, 158, 202, 237)
NCS_FORMAT4 = (2, 4, 6, 8, 10, 12, 15)


@functools.lru_cache(maxsize=None)
def d_u(u: int) -> int:
    """Cyclic Doppler distance of root u: p with (p*u) mod NZC = 1, folded."""
    p = pow(u, -1, NZC)
    return p if p < NZC // 2 else NZC - p


def restricted_shifts(u: int, n_cs: int) -> list[int]:
    """Allowed C_v values for root u in a restricted (type A) set.

    36.211 §5.7.2 N_shift/d_start/N_group/N_neg algebra
    (srsran_prach_gen_seqs high-speed branch).  Empty if the root admits
    no shifts.
    """
    du = d_u(u)
    if n_cs <= du < NZC // 3:
        n_shift = du // n_cs
        d_start = 2 * du + n_shift * n_cs
        n_group = NZC // d_start
        n_neg = max((NZC - 2 * du - n_group * d_start) // n_cs, 0)
    elif NZC // 3 <= du <= (NZC - n_cs) // 2:
        n_shift = (NZC - 2 * du) // n_cs
        d_start = NZC - 2 * du + n_shift * n_cs
        n_group = du // d_start
        n_neg = min(max((du - n_group * d_start) // n_cs, 0), n_shift)
    else:
        return []
    if n_shift == 0:
        return []
    n_v = n_shift * n_group + n_neg
    return [d_start * (v // n_shift) + (v % n_shift) * n_cs
            for v in range(n_v)]


@dataclass(frozen=True)
class PrachConfig:
    params: OfdmParams  # cell UL numerology (sets the sample rate)
    root_seq_idx: int = 0  # LOGICAL root sequence index (rootSequenceIndex)
    zero_corr_cfg: int = 4  # index into the N_cs table
    freq_offset_prb: int = 0  # n_PRB_RA offset from the band edge
    fmt: int = 0
    high_speed: bool = False  # restricted set type A

    def __post_init__(self):
        if self.fmt == 4 and self.high_speed:
            raise ValueError("format 4 has no restricted sets (36.211)")

    @property
    def nzc(self) -> int:
        return NZC_SHORT if self.fmt == 4 else NZC

    @property
    def delta_f_ra(self) -> int:
        return DELTA_F_RA_4 if self.fmt == 4 else DELTA_F_RA

    @property
    def k(self) -> int:
        return 15000 // self.delta_f_ra

    @property
    def phi(self) -> int:
        return 2 if self.fmt == 4 else PHI

    @property
    def n_cs(self) -> int:
        if self.fmt == 4:
            return NCS_FORMAT4[self.zero_corr_cfg]
        if self.high_speed:
            return NCS_RESTRICTED[self.zero_corr_cfg]
        return NCS_UNRESTRICTED[self.zero_corr_cfg]

    @property
    def shifts_per_root(self) -> int:
        return self.nzc // self.n_cs if self.n_cs else 1

    @functools.cached_property
    def preamble_table(self) -> tuple[tuple[int, int], ...]:
        """64 preambles as (physical root u, cyclic shift C_v), walking
        consecutive logical indices from root_seq_idx (prach.c:380)."""
        tab = logical_roots(short=self.fmt == 4)
        out: list[tuple[int, int]] = []
        i = 0
        while len(out) < 64:
            u = int(tab[(self.root_seq_idx + i) % len(tab)])
            i += 1
            if self.high_speed:
                cvs = restricted_shifts(u, self.n_cs)
            else:
                cvs = [v * self.n_cs for v in range(self.shifts_per_root)]
            for cv in cvs:
                out.append((u, cv))
                if len(out) == 64:
                    break
        return tuple(out)

    @functools.cached_property
    def roots(self) -> tuple[int, ...]:
        """Distinct physical roots used by the 64 preambles, in order."""
        seen: list[int] = []
        for u, _ in self.preamble_table:
            if u not in seen:
                seen.append(u)
        return tuple(seen)

    @property
    def n_roots(self) -> int:
        return len(self.roots)

    @property
    def srate(self) -> int:
        return self.params.srate

    @property
    def n_fft(self) -> int:
        return self.srate // self.delta_f_ra  # IFFT covering one sequence

    @property
    def n_cp(self) -> int:
        return FORMAT_CP[self.fmt] * self.srate // 30_720_000

    @property
    def n_seq(self) -> int:
        return FORMAT_SEQ[self.fmt] * self.srate // 30_720_000

    @property
    def n_total(self) -> int:
        return self.n_cp + self.n_seq

    @functools.cached_property
    def first_bin(self) -> int:
        """First occupied RA-spacing bin relative to the UL carrier DC.

        36.211 §5.7.3: k0 = n_PRB_RA*12 - N_RB_UL*6; bin = phi + K*k0 + K/2.
        """
        k0 = self.freq_offset_prb * 12 - self.params.n_prb * 6
        return self.phi + self.k * k0 + self.k // 2

    def preamble_uv(self, idx: int) -> tuple[int, int]:
        """Preamble index (0..63) -> (root u, cyclic shift C_v)."""
        return self.preamble_table[idx]


@functools.lru_cache(maxsize=None)
def _root_dft(u: int, nzc: int = NZC) -> np.ndarray:
    return np.fft.fft(zadoff_chu(u, nzc)).astype(np.complex64)


def prach_gen(cfg: PrachConfig, preamble_idx: int) -> np.ndarray:
    """Time-domain preamble at the cell sample rate: [n_cp + n_seq] c64."""
    u, cv = cfg.preamble_uv(preamble_idx)
    x = zadoff_chu(u, cfg.nzc)
    xv = np.roll(x, -cv)
    xf = np.fft.fft(xv)
    bins = np.zeros(cfg.n_fft, np.complex64)
    bins[(cfg.first_bin + np.arange(cfg.nzc)) % cfg.n_fft] = xf
    seq = np.fft.ifft(bins).astype(np.complex64)
    rep = 2 if cfg.fmt in (2, 3) else 1
    seq_full = np.tile(seq, rep)[: cfg.n_seq]
    out = np.concatenate([seq_full[-cfg.n_cp :], seq_full])
    return (out / np.sqrt(np.mean(np.abs(out) ** 2))).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _detect_tables(cfg: PrachConfig):
    """(occupied bins [nzc], conj root DFTs [nroots, nzc], preamble -> root
    [64], flat lag-window indices [64, W, ncs]) of a configuration.

    A preamble sent with shift C_v peaks at lag (NZC - C_v) mod NZC, and a
    propagation delay of d samples moves the peak forward by d*NZC/n_fft, so
    the window for C_v is [(NZC - C_v) .. (NZC - C_v) + ncs) mod NZC.
    Restricted sets: a Doppler-shifted preamble aliases to C_v -+ d_u, so
    those windows are searched too."""
    n, nzc = cfg.n_fft, cfg.nzc
    occ = ((cfg.first_bin + np.arange(nzc)) % n).astype(np.int64)
    roots = np.conj(np.stack([_root_dft(u, nzc) for u in cfg.roots]))
    ncs = cfg.n_cs if cfg.n_cs else nzc
    rix = {u: i for i, u in enumerate(cfg.roots)}
    root_idx = np.array([rix[u] for u, _ in cfg.preamble_table])  # [64]
    offs = np.array([[0, d_u(u), nzc - d_u(u)] for u, _ in
                     cfg.preamble_table]) if cfg.high_speed else \
        np.zeros((64, 1), np.int64)  # [64, W]
    cvs = np.array([cv for _, cv in cfg.preamble_table])  # [64]
    lag = (nzc - cvs[:, None, None] + offs[:, :, None]
           + np.arange(ncs)[None, None, :]) % nzc  # [64, W, ncs]
    flat_idx = (root_idx[:, None, None] * nzc + lag).astype(np.int64)
    return occ, roots.astype(np.complex64), root_idx.astype(np.int64), flat_idx


def prach_detect(cfg: PrachConfig, samples, threshold: float = 13.0,
                 device=None):
    # threshold calibration: correlation noise is ~exp(1) after normalization,
    # so the per-window false-alarm rate is ~NZC * exp(-threshold) (2e-3 @ 13)
    """Detect preambles in a window starting at the PRACH CP start.

    samples [..., >= n_total] at the cell rate.  Returns
    (detected [..., 64] bool, metric [..., 64], t_offset [..., 64] int32 in
    samples at the cell rate).  metric is peak power over the mean power of
    the correlation (prach.c uses a comparable peak/side-lobe ratio).
    """
    samples = as_tensor(samples, device).to(torch.complex64)
    dev = samples.device
    n, nzc = cfg.n_fft, cfg.nzc
    tabs = lambda i: _detect_tables(cfg)[i]
    occ = table(("prach_occ", cfg), dev, lambda: tabs(0))
    roots = table(("prach_roots", cfg), dev, lambda: tabs(1))
    root_idx = table(("prach_root_idx", cfg), dev, lambda: tabs(2))
    flat_idx = table(("prach_lags", cfg), dev, lambda: tabs(3))

    seq = samples[..., cfg.n_cp : cfg.n_cp + n]  # one sequence period
    y = torch.fft.fft(seq, dim=-1)[..., occ]  # [..., nzc]
    corr = torch.fft.ifft(y[..., None, :] * roots, dim=-1)  # [..., nroots, nzc]
    p = torch.abs(corr) ** 2  # power vs cyclic lag
    floor = torch.mean(p, dim=-1)  # [..., nroots]
    pf = p.reshape(p.shape[:-2] + (-1,))  # [..., nroots*nzc]
    region = pf[..., flat_idx]  # [..., 64, W, ncs]
    peak = torch.amax(region, dim=(-1, -2))
    metric = peak / torch.clamp(floor[..., root_idx], min=1e-12)
    det = metric > threshold
    # timing from the MAIN (non-aliased) window; the product is taken to
    # float32 before the division, as the JAX package's integer true divide
    arg = torch.argmax(region[..., 0, :], dim=-1)
    t_off = ((arg * n).to(torch.float32) / nzc).to(torch.int32)
    return det, metric, t_off
