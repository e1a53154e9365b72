# Frozen copy of srslte_tpu_torch/phy/common/zc.py at commit e4337f4, unchanged but for this line.
"""Zadoff-Chu sequences (36.211 §5.7.2 / §6.11.1).

Reference behavior: lib/src/phy/common/zc_sequence.c, lib/src/phy/sync/pss.c
(srsran_pss_generate).  Pure numpy — these are config-time tables.
"""

from __future__ import annotations

import numpy as np

PSS_ROOT = {0: 25, 1: 29, 2: 34}  # N_id_2 -> ZC root u (36.211 table 6.11.1.1-1)


def zadoff_chu(root: int, length: int, q: int = 0) -> np.ndarray:
    """General odd/even-length ZC sequence, complex64."""
    n = np.arange(length)
    if length % 2:
        arg = -np.pi * root * n * (n + 1 + 2 * q) / length
    else:
        arg = -np.pi * root * n * n / length
    return np.exp(1j * arg).astype(np.complex64)


def pss_sequence(n_id_2: int) -> np.ndarray:
    """Frequency-domain PSS, 62 subcarriers (36.211 §6.11.1.1, pss.c gen).

    d_u(n) = exp(-j pi u n (n+1) / 63)            for n = 0..30
             exp(-j pi u (n+1)(n+2) / 63)         for n = 31..61
    """
    u = PSS_ROOT[n_id_2]
    n = np.arange(62)
    arg = np.where(n < 31, -np.pi * u * n * (n + 1) / 63.0, -np.pi * u * (n + 1) * (n + 2) / 63.0)
    return np.exp(1j * arg).astype(np.complex64)
