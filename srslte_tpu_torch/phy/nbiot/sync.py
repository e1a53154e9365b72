"""NB-IoT synchronization signals: NPSS/NSSS (36.211 §10.2.7, npss.c/nsss.c).

Reference behavior: lib/src/phy/sync/{npss.c, nsss.c} — NPSS is a length-11
Zadoff-Chu (root 5) repeated over 11 OFDM symbols of subframe 5 with a
per-symbol cover code; NSSS (subframe 9, even frames) is a length-131 ZC
with root/cyclic-shift encoding the 504 NB cell ids x 4 frame positions.

NPSS detection is one FFT correlation padded to a power of two
(``torch.fft`` with ``n=``); NSSS detection correlates against the full
[504*4, 132] candidate bank with one product.  Both banks are host tables
uploaded once per device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table
from ..common.params import OfdmParams

# 36.211 table 10.2.7.1.1-1: NPSS symbol cover code (symbols 3..13)
NPSS_COVER = np.array([1, 1, 1, 1, -1, -1, 1, 1, 1, -1, 1], np.float32)
NPSS_ROOT = 5
NSSS_LEN = 131


@functools.lru_cache(maxsize=1)
def npss_sequence() -> np.ndarray:
    """Frequency-domain NPSS: [11 symbols, 11 subcarriers] complex64."""
    n = np.arange(11)
    d = np.exp(-1j * np.pi * NPSS_ROOT * n * (n + 1) / 11.0)
    return (NPSS_COVER[:, None] * d[None, :]).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def npss_time(fft_size: int = 128) -> np.ndarray:
    """Time-domain NPSS replica over 11 symbols incl. CP: unit energy."""
    p = OfdmParams(6)  # 1.92 Msps numerology; NB-IoT uses one PRB of it
    assert fft_size == p.symbol_sz
    seq = npss_sequence()
    out = []
    cps = (p.cp_lens_slot() * 2)[3:14]  # symbols 3..13 of the subframe
    for i in range(11):
        bins = np.zeros(fft_size, np.complex64)
        bins[1 : 12] = seq[i]  # subcarriers 0..10 of the NB-IoT PRB (+DC off)
        sym = np.fft.ifft(bins)
        out.append(np.concatenate([sym[-cps[i] :], sym]))
    t = np.concatenate(out).astype(np.complex64)
    return (t / np.linalg.norm(t)).astype(np.complex64)


def npss_find(x, fft_size: int = 128, device=None):
    """Correlate x [..., L] with the NPSS replica -> (offset, metric)."""
    x = as_tensor(x, device).to(torch.complex64)
    rep = npss_time(fft_size)
    L = x.shape[-1]
    nvalid = L - len(rep) + 1
    conv_len = int(2 ** np.ceil(np.log2(L)))
    bank = table(("npss_bank", fft_size, conv_len), x.device,
                 lambda: np.conj(np.fft.fft(rep, conv_len)).astype(np.complex64))
    corr = torch.fft.ifft(torch.fft.fft(x, n=conv_len) * bank)[..., :nvalid]
    p = torch.abs(corr) ** 2
    e = torch.cumsum(torch.abs(x) ** 2, dim=-1)
    win = e[..., len(rep) - 1 :] - torch.cat(
        [torch.zeros_like(e[..., :1]), e[..., : nvalid - 1]], dim=-1)
    pn = p / torch.clamp(win, min=1e-12)
    off = torch.argmax(pn, dim=-1)
    return off.to(torch.int32), torch.gather(pn, -1, off[..., None])[..., 0]


@functools.lru_cache(maxsize=1)
def _nsss_bank() -> np.ndarray:
    """[504*4, 132] candidate NSSS sequences (cell id x frame position)."""
    n = np.arange(132)
    np_ = n % NSSS_LEN
    bank = np.zeros((504 * 4, 132), np.complex64)
    # 36.211 §10.2.7.2: u = NID mod 126 + 3, theta_f = 33/132 * (nf/2 mod 4),
    # cyclic shift b_q(n) hadamard cover with q = floor(NID/126)
    had = _hadamard128()
    for nid in range(504):
        u = nid % 126 + 3
        q = nid // 126
        zc = np.exp(-1j * np.pi * u * np_ * (np_ + 1) / NSSS_LEN)
        bq = had[32 * q][n % 128].astype(np.float32)  # rows {0,32,64,96}
        for f in range(4):
            theta = 33.0 / 132.0 * f
            rot = np.exp(-2j * np.pi * theta * n)
            bank[nid * 4 + f] = (bq * rot * zc).astype(np.complex64)
    return bank


def _hadamard128():
    h = np.array([[1.0]])
    while h.shape[0] < 128:
        h = np.block([[h, h], [h, -h]])
    return h


def nsss_sequence(nid: int, frame_pos: int) -> np.ndarray:
    """NSSS d(0..131) for a cell id and (nf/2 mod 4) frame position."""
    return _nsss_bank()[nid * 4 + frame_pos]


def nsss_find(d132, device=None):
    """d132 [..., 132] received NSSS REs -> (nid, frame_pos, metric).

    One [2016, 132] product against all candidates.
    """
    d132 = as_tensor(d132, device).to(torch.complex64)
    bank_h = table("nsss_bank_h", d132.device, lambda: np.conj(_nsss_bank()).T)
    corr = torch.abs(torch.matmul(d132, bank_h)) ** 2
    best = torch.argmax(corr, dim=-1)
    energy = torch.sum(torch.abs(d132) ** 2, dim=-1) * 132
    metric = torch.gather(corr, -1, best[..., None])[..., 0] / torch.clamp(energy, min=1e-12)
    return (best // 4).to(torch.int32), (best % 4).to(torch.int32), metric
