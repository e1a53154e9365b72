"""Sidelink synchronization signals PSSS/SSSS (36.211 §9.7, psss.c/ssss.c).

PSSS: length-62 ZC-style sequences with roots 26/37 (N_id_2 in {0, 1},
negative sign — psss.c:150) in symbols 1-2 of the sync subframe; SSSS: the
LTE SSS m-sequence construction with id1 = N_sl_id mod 168,
id2 = N_sl_id div 168, subframe-0 variant for TM1/2 (ssss.c:168).

Each detector is one product of the received 62 subcarriers with its bank
(2 or 336 candidates, uploaded once per device) and one host read of the
winner and its metric.  Ties go to the first maximum.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table
from ..sync.sss import sss_sequence

PSSS_LEN = 62
PSSS_ROOTS = (26, 37)


@functools.lru_cache(maxsize=None)
def psss_sequence(n_id_2: int) -> np.ndarray:
    """[62] complex64 (psss.c srsran_psss_generate:145)."""
    root = PSSS_ROOTS[n_id_2]
    i = np.arange(PSSS_LEN, dtype=np.float64)
    arg = np.where(i < 31, -np.pi * root * i * (i + 1) / 63,
                   -np.pi * root * (i + 2) * (i + 1) / 63)
    return np.exp(1j * arg).astype(np.complex64)


@functools.lru_cache(maxsize=None)
def ssss_sequence(n_sl_id: int) -> np.ndarray:
    """[62] SSSS (subframe-0 sequence, TM1/2)."""
    return sss_sequence(n_sl_id % 168, n_sl_id // 168, sf5=False)


def _detect(y, bank) -> tuple[int, float]:
    """argmax over the bank of |<cand, y>| / (|y| sqrt(62)): one host read."""
    c = torch.abs(torch.einsum("cn,...n->...c", torch.conj(bank), y))
    c = c / torch.clamp(torch.linalg.norm(y, dim=-1)[..., None] * float(np.sqrt(PSSS_LEN)),
                        min=1e-12)
    best, val = torch.argmax(c, dim=-1), torch.amax(c, dim=-1)
    best, val = torch.stack([best.to(torch.float64), val.to(torch.float64)]).tolist()
    return int(best), val


def psss_detect(d62, device=None) -> tuple[int, float]:
    """Frequency-domain detect over the center 62 SCs -> (N_id_2, corr)."""
    d62 = as_tensor(d62, device).to(torch.complex64)
    bank = table(("psss_bank",), d62.device,
                 lambda: np.stack([psss_sequence(i) for i in range(2)]))
    return _detect(d62, bank)


def ssss_detect(d62, coherent_ref=None, device=None) -> tuple[int, float]:
    """Full-bank SSSS detect: correlate all 336 ids -> (N_sl_id, corr).

    `coherent_ref` (e.g. the PSSS-derived channel estimate over the 62 SCs)
    equalizes before correlation when given."""
    y = as_tensor(d62, device).to(torch.complex64)
    bank = table(("ssss_bank",), y.device,
                 lambda: np.stack([ssss_sequence(i) for i in range(336)]).astype(np.complex64))
    if coherent_ref is not None:
        ref = as_tensor(coherent_ref, y.device).to(torch.complex64)
        y = y * torch.conj(ref) / torch.clamp(torch.abs(ref) ** 2, min=1e-12)
    return _detect(y, bank)
