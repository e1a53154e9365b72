"""Narrowband reference signals (36.211 §10.2.6, refsignal_dl_nbiot.c).

NRS live in the last two symbols of each slot (subframe symbols 5/6/12/13),
two pilots per symbol per port at subcarriers 6m + (v + n_id mod 6) mod 6
with v = 0/3 (port 0) or 3/0 (port 1); values are CRS-style gold QPSK with
c_init = 1024(7(ns+1)+l'+1)(2N+1) + 2N + 1 and the 110-PRB centering
offset (refsignal_dl_nbiot.c:122-180).
"""

from __future__ import annotations

import functools

import numpy as np

from ..common.sequence import gold_sequence

NRS_SYMBOLS = (5, 6, 12, 13)  # subframe symbol indices (normal CP)
MAX_PRB = 110


def _v(port: int, l_idx: int) -> int:
    """v-shift per port and RS-symbol index (refsignal_dl_nbiot.c:37)."""
    if port == 0:
        return 0 if l_idx % 2 == 0 else 3
    return 3 if l_idx % 2 == 0 else 0


@functools.lru_cache(maxsize=None)
def nrs_subcarriers(n_id: int, port: int) -> np.ndarray:
    """[4, 2] subcarrier of each pilot per NRS symbol."""
    out = np.zeros((4, 2), np.int32)
    for li in range(4):
        for m in range(2):
            out[li, m] = 6 * m + (_v(port, li) + n_id % 6) % 6
    return out


@functools.lru_cache(maxsize=None)
def nrs_values(n_id: int, sf_idx: int) -> np.ndarray:
    """[4, 2] pilot values for the subframe's four NRS symbols (per port
    the values are identical — the sequence depends only on slot/symbol)."""
    out = np.zeros((4, 2), np.complex64)
    for li, nsym in enumerate(NRS_SYMBOLS):
        ns = 2 * sf_idx + nsym // 7
        lp = nsym % 7
        c_init = (1024 * (7 * (ns + 1) + lp + 1) * (2 * n_id + 1)
                  + 2 * n_id + 1) % (1 << 31)
        c = gold_sequence(c_init, 2 * (2 * MAX_PRB)).astype(np.float32)
        for m in range(2):
            mp = m + MAX_PRB - 1
            out[li, m] = ((1 - 2 * c[2 * mp])
                          + 1j * (1 - 2 * c[2 * mp + 1])) / np.sqrt(2)
    return out


def nrs_reserved_sc(n_id: int, nof_ports: int) -> dict[int, set]:
    """{symbol: set(subcarriers)} reserved by NRS for `nof_ports` ports."""
    res: dict[int, set] = {s: set() for s in NRS_SYMBOLS}
    for p in range(nof_ports):
        scs = nrs_subcarriers(n_id, p)
        for li, s in enumerate(NRS_SYMBOLS):
            res[s].update(scs[li].tolist())
    return res
