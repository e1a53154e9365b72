"""PSS generation, matched-filter search, and PSS-based CFO estimation.

Reference behavior: lib/src/phy/sync/pss.c: srsran_pss_generate (freq ZC,
:483), time-domain replica via centered IFFT, srsran_pss_find_pss (:446)
FFT-based matched filter (srsran_conv_fft_cc_run_opt, :464-480), and
srsran_pss_cfo_compute (half-symbol phase method).

The C library searches one N_id_2 at a time with early exit; here all 3
roots are one batched FFT correlation (the filter bank is a [3, Nfft]
table), and many search windows batch over leading dims.  Peak picking is an
argmax and the normalization a cumsum-based sliding energy, both in float32.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..._device import as_tensor, table, take
from ..common.zc import pss_sequence

PSS_LEN = 62


@functools.lru_cache(maxsize=None)
def pss_time(n_id_2: int, fft_size: int) -> np.ndarray:
    """Time-domain PSS replica for one OFDM symbol (no CP): [fft_size] c64.

    Maps the 62 freq-domain ZC values onto centered bins (DC skipped) exactly
    like the OFDM modulator mirror map (pss.c places d(0..30) at bins 1..31
    and d(31..61) at bins N-31..N-1), then unnormalized IFFT * N / sqrt(62)
    is NOT applied: the replicas keep unit energy so correlation magnitudes
    are comparable across fft sizes.
    """
    d = pss_sequence(n_id_2)
    bins = np.zeros(fft_size, np.complex64)
    bins[1 : 32] = d[31:]  # d(31..61) -> +1..+31  (upper half above DC)
    bins[fft_size - 31 :] = d[:31]  # d(0..30) -> -31..-1
    t = np.fft.ifft(bins).astype(np.complex64)
    return (t / np.linalg.norm(t)).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def _pss_filter_bank(fft_size: int, conv_len: int) -> np.ndarray:
    """conj(FFT) of the 3 replicas zero-padded to conv_len: [3, conv_len]."""
    bank = np.stack([
        np.conj(np.fft.fft(pss_time(n, fft_size), conv_len)) for n in range(3)
    ])
    return bank.astype(np.complex64)


def _replicas(fft_size: int) -> np.ndarray:
    return np.stack([pss_time(n, fft_size) for n in range(3)])


def pss_find(x, fft_size: int, norm: bool = True, device=None):
    """Correlate x [..., L] against all 3 PSS roots.

    Returns corr [..., 3, L - fft_size + 1]: corr[..., u, k] =
    |sum_n x[k+n] conj(pss_u[n])|^2, optionally normalized by the sliding
    window energy of x (CFAR-like, the C library's peak/side-lobe
    normalization intent).
    """
    x = as_tensor(x, device)
    L = x.shape[-1]
    nvalid = L - fft_size + 1
    if nvalid <= 0:
        raise ValueError(f"window {L} shorter than fft_size {fft_size}")
    conv_len = int(2 ** np.ceil(np.log2(L)))
    bank = table(("pss_bank", fft_size, conv_len), x.device,
                 lambda: _pss_filter_bank(fft_size, conv_len))
    xf = torch.fft.fft(x, n=conv_len, dim=-1)
    corr = torch.fft.ifft(xf[..., None, :] * bank, dim=-1)[..., :nvalid]
    p = torch.abs(corr) ** 2
    if norm:
        e = torch.cumsum(torch.abs(x) ** 2, dim=-1)
        win = e[..., fft_size - 1 :] - torch.cat(
            [torch.zeros_like(e[..., :1]), e[..., : nvalid - 1]], dim=-1)
        p = p / torch.clamp(win[..., None, :], min=1e-12)
    return p


def pss_find_peak(x, fft_size: int, device=None):
    """Batched search: returns (n_id_2, offset, metric) per leading batch.

    offset is the sample index where the PSS symbol (without CP) starts.
    metric is the normalized correlation power in [0, 1].  Ties go to the
    first maximum (root-major), as in the JAX package.
    """
    p = pss_find(x, fft_size, device=device)  # [..., 3, nvalid]
    flat = p.reshape(p.shape[:-2] + (-1,))
    am = torch.argmax(flat, dim=-1)
    nvalid = p.shape[-1]
    n_id_2 = torch.div(am, nvalid, rounding_mode="floor").to(torch.int32)
    offset = (am % nvalid).to(torch.int32)
    metric = torch.gather(flat, -1, am[..., None])[..., 0]
    return n_id_2, offset, metric


def pss_cfo_compute(x_sym, n_id_2, fft_size: int, device=None):
    """CFO (in subcarrier-spacing units) from one received PSS symbol.

    The C library's method (pss.c srsran_pss_cfo_compute): correlate each
    half of the received symbol with the replica half; the sign is such that
    a positive CFO rotates the second half forward: cfo = arg(c1 conj(c0)) / pi.
    n_id_2 is an int or an integer tensor of the batch shape of x_sym[..., 0].
    """
    x_sym = as_tensor(x_sym, device)
    bank = table(("pss_replicas", fft_size), x_sym.device, lambda: _replicas(fft_size))
    rep = take(bank, torch.as_tensor(n_id_2, device=x_sym.device).long())
    half = fft_size // 2
    c0 = torch.sum(x_sym[..., :half] * torch.conj(rep[..., :half]), dim=-1)
    c1 = torch.sum(x_sym[..., half:] * torch.conj(rep[..., half:]), dim=-1)
    return torch.angle(c1 * torch.conj(c0)) / math.pi
