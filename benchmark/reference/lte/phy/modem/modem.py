# Frozen copy of srslte_tpu_torch/phy/modem/modem.py at commit e4337f4, unchanged but for this line.
"""Modulation mapping + max-log soft demodulation (36.211 §7.1).

Reference behavior: lib/src/phy/modem/{lte_tables.c, mod.c, demod_soft.c}.
Constellations are generated from the 36.211 Gray-mapping formulas.  LLR sign
convention matches demod_soft.c: **positive LLR => bit 1** (llr0 = -y_re
etc.), so scrambling can flip LLR signs and the FEC decoders consume them
directly.

Modulation is a single gather from a 2^Qm-entry table; soft demodulation is
the branchless piecewise-linear max-log form (abs/sub chains) over arbitrary
batch shapes.
"""

from __future__ import annotations

import enum
import functools

import numpy as np
import torch

from ..._device import as_tensor, table


class Modulation(enum.Enum):
    BPSK = 1
    QPSK = 2
    QAM16 = 4
    QAM64 = 6
    QAM256 = 8

    @property
    def bits_per_symbol(self) -> int:
        return self.value


MOD_BITS = {m: m.value for m in Modulation}


def constellation(mod: Modulation) -> np.ndarray:
    """2^Qm complex64 table, index = bits MSB-first (b0 b1 ... b_{Qm-1})."""
    if mod is Modulation.BPSK:
        lv = 1 / np.sqrt(2)
        return np.array([lv + 1j * lv, -lv - 1j * lv], dtype=np.complex64)
    qm = mod.bits_per_symbol
    idx = np.arange(2**qm)
    bits = (idx[:, None] >> np.arange(qm - 1, -1, -1)[None, :]) & 1
    # even bit positions drive I, odd positions drive Q (36.211 tables)
    i_lv = _gray_pam(bits[:, 0::2])
    q_lv = _gray_pam(bits[:, 1::2])
    norm = {2: 2, 4: 10, 6: 42, 8: 170}[qm]
    return ((i_lv + 1j * q_lv) / np.sqrt(norm)).astype(np.complex64)


def _gray_pam(bits: np.ndarray) -> np.ndarray:
    """36.211 PAM recursion: L_n(b0,rest) = (1-2b0) * (2^(n-1) - L_{n-1}(rest)).

    E.g. 64QAM x-level for (b0,b2,b4): (1-2b0)*(4-(1-2b2)*(2-(1-2b4))),
    matching table 7.1.4-1 / lte_tables.c set_64QAMtable.
    """
    nb = bits.shape[-1]
    s = 1 - 2 * bits[..., 0].astype(np.int64)
    if nb == 1:
        return s
    return s * (2 ** (nb - 1) - _gray_pam(bits[..., 1:]))


@functools.lru_cache(maxsize=None)
def _table(mod: Modulation) -> np.ndarray:
    return constellation(mod)


def modulate(bits, mod: Modulation, device=None):
    """bits [..., n*Qm] {0,1} -> symbols [..., n] complex64."""
    bits = as_tensor(bits, device)
    qm = mod.bits_per_symbol
    tab = table(("constellation", mod), bits.device, lambda: _table(mod))
    b = bits.reshape(bits.shape[:-1] + (-1, qm)).to(torch.int64)
    weights = table(("bit_weights", qm), bits.device,
                    lambda: 2 ** np.arange(qm - 1, -1, -1, dtype=np.int64))
    idx = torch.sum(b * weights, dim=-1)
    return tab[idx]


def demod_soft(symbols, mod: Modulation, device=None):
    """symbols [..., n] -> float LLRs [..., n*Qm]; positive => bit 1.

    Matches demod_soft.c float formulas exactly (max-log piecewise form).
    """
    symbols = as_tensor(symbols, device)
    y_re, y_im = symbols.real, symbols.imag
    if mod is Modulation.BPSK:
        return -(y_re + y_im) * float(np.float32(1 / np.sqrt(2)))
    if mod is Modulation.QPSK:
        llr = torch.stack([-y_re, -y_im], dim=-1) * float(np.float32(np.sqrt(2)))
        return llr.reshape(symbols.shape[:-1] + (-1,))

    qm = mod.bits_per_symbol
    norm = np.float32(1.0 / np.sqrt({4: 10, 6: 42, 8: 170}[qm]))
    lvls = {4: (2,), 6: (4, 2), 8: (8, 4, 2)}[qm]
    pairs = [-y_re, -y_im]
    cur_re, cur_im = -y_re, -y_im
    for lv in lvls:
        off = float(np.float32(lv) * norm)
        cur_re = torch.abs(cur_re) - off
        cur_im = torch.abs(cur_im) - off
        pairs.extend([cur_re, cur_im])
    llr = torch.stack(pairs, dim=-1)  # [..., n, Qm]
    return llr.reshape(symbols.shape[:-1] + (-1,))
