# Frozen copy of srslte_tpu_torch/phy/phch/regs.py at commit e4337f4, unchanged but for this line.
"""Control-region REG/CCE geometry (36.211 §6.2.4/§6.7.4/§6.8.5/§6.9.3).

Reference behavior: lib/src/phy/phch/regs.c — REG enumeration ordered by
(k0, then l) (regs.c:731-756 round-robin loop), PCFICH anchored at
k̂ = 6*(N_id mod 2*N_prb) (regs_pcfich_init, :492), PHICH groups at
n_i = (N_id + m + floor(i*n_l/3)) mod n_l over non-PCFICH REGs — symbol 0
for normal duration, symbols 0/1/2 per quadruplet for extended duration
(regs_phich_init, :326-344), PDCCH sub-block interleaving with the 32-column
permutation + cell-id cyclic shift truncated to whole CCEs
(regs_pdcch_init, :67-128).

Everything here is host-side numpy executed once per (cell, cfi) bucket; the
output is flat RE-index tables that turn the C library's pointer-chasing
put/get loops into single device gathers.  RE indices address
the flattened subframe grid (l * nof_re + k) since the control region lives
in slot 0.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np

from ..common.params import CP, Cell

PDCCH_NCOLS = 32
# same sub-block permutation as convolutional rate matching (36.212 §5.1.4.2.1)
PDCCH_PERM = np.array([1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31,
                       0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30])

PHICH_NG = {"1/6": 1 / 6, "1/2": 0.5, "1": 1.0, "2": 2.0}


def _regs_per_prb(l: int, nof_ports: int, cp: CP) -> int:
    """REGs per PRB in control symbol l (36.211 §6.2.4)."""
    if l == 0:
        return 2
    if l == 1:
        return 2 if nof_ports == 4 else 3
    if l == 2:
        return 3
    return 3 if cp is CP.NORM else 2


def _reg_res(l: int, reg_idx: int, prb: int, maxreg: int, vo: int):
    """(base k0, the 4 subcarrier indices) of one REG."""
    if maxreg == 2:
        base = prb * 12 + reg_idx * 6
        ks = [base + i for i in range(6) if i != vo and i != vo + 3]
    else:
        base = prb * 12 + reg_idx * 4
        ks = [base + i for i in range(4)]
    return base, np.asarray(ks, np.int64)


@dataclass(frozen=True)
class RegLayout:
    """All control-region index tables for one cell.

    pcfich_re: [16] flat subframe-grid indices of the 4 PCFICH quadruplets.
    phich_re:  [ngroups, 12] per PHICH group (normal duration).
    pdcch_re:  {cfi: [n_regs*4]} flat indices in quadruplet-sequence order —
               quadruplet m of the multiplexed+interleaved PDCCH bit stream
               occupies pdcch_re[cfi][4m:4m+4].
    n_cce:     {cfi: CCE count} (= n_regs // 9).
    """

    pcfich_re: np.ndarray
    phich_re: np.ndarray
    pdcch_re: dict
    n_cce: dict

    @property
    def ngroups_phich(self) -> int:
        return self.phich_re.shape[0]


def nof_ctrl_symbols(cell: Cell, cfi: int) -> int:
    """Actual control symbols for a CFI value (cfi+1 when N_prb <= 10)."""
    return cfi if cell.n_prb > 10 else cfi + 1


@functools.lru_cache(maxsize=None)
def reg_layout(cell: Cell) -> RegLayout:
    nre = cell.ofdm.nof_re
    max_ctrl = 4 if cell.n_prb <= 10 else 3
    vo = cell.id % 3

    # enumerate all REGs of the max control region, ordered (k0, then l)
    regs = []  # (k0, l, res[4])
    for prb in range(cell.n_prb):
        for l in range(max_ctrl):
            n = _regs_per_prb(l, cell.nof_ports, cell.cp)
            for j in range(n):
                k0, res = _reg_res(l, j, prb, n, vo)
                regs.append((k0, l, res))
    regs.sort(key=lambda r: (r[0], r[1]))
    assigned = np.zeros(len(regs), bool)

    def flat(l, res):
        return l * nre + res

    # --- PCFICH: 4 REGs in symbol 0
    k_hat = 6 * (cell.id % (2 * cell.n_prb))
    pcfich = []
    for i in range(4):
        k = (k_hat + (i * cell.n_prb // 2) * 6) % nre
        hit = next(j for j, (k0, l, _) in enumerate(regs) if l == 0 and k0 == k)
        assigned[hit] = True
        pcfich.append(flat(0, regs[hit][2]))
    pcfich_re = np.concatenate(pcfich).astype(np.int32)

    # --- PHICH (FDD m_i = 1): normal duration puts all 3 quadruplets of a
    # group in symbol 0; extended duration spreads them over symbols 0/1/2
    # (36.211 table 6.9.3-1, regs_phich_init regs.c:326-344).  Extended
    # duration implies a >=3-symbol control region (CFI >= 3).
    ext_dur = cell.phich_length == "ext"
    ngroups = math.ceil(PHICH_NG[cell.phich_resources] * cell.n_prb / 8)
    sym_regs = {l: [j for j, (k0, rl, _) in enumerate(regs)
                    if rl == l and not assigned[j]] for l in range(3)}
    phich = np.zeros((ngroups, 12), np.int32)
    taken = set()
    for m in range(ngroups):
        for i in range(3):
            li = i if ext_dur else 0
            avail = sym_regs[li]
            nl = len(avail)
            ni = (cell.id + m + i * nl // 3) % nl
            j = avail[ni]
            if j in taken:
                raise RuntimeError("PHICH REG collision (config too dense)")
            taken.add(j)
            phich[m, 4 * i : 4 * i + 4] = flat(li, regs[j][2])
    for j in taken:
        assigned[j] = True

    # --- PDCCH per CFI: interleave + cyclic shift
    pdcch_re, n_cce = {}, {}
    for cfi in (1, 2, 3):
        nctrl = nof_ctrl_symbols(cell, cfi)
        tmp = [j for j, (k0, l, _) in enumerate(regs)
               if l < nctrl and not assigned[j]]
        nregs = len(tmp)
        nrows = (nregs - 1) // PDCCH_NCOLS + 1
        ndummy = PDCCH_NCOLS * nrows - nregs
        # column-read order: output position k holds input quadruplet m
        order = np.full(nregs, -1, np.int64)  # m -> REG sequence pos
        k = 0
        for j in range(PDCCH_NCOLS):
            for i in range(nrows):
                p = i * PDCCH_NCOLS + PDCCH_PERM[j]
                if p >= ndummy:
                    m = p - ndummy
                    order[m] = (k - cell.id) % nregs
                    k += 1
        nregs_cce = (nregs // 9) * 9
        idx = np.concatenate([flat(regs[tmp[order[m]]][1], regs[tmp[order[m]]][2])
                              for m in range(nregs_cce)])
        pdcch_re[cfi] = idx.astype(np.int32)
        n_cce[cfi] = nregs_cce // 9

    return RegLayout(pcfich_re, phich, pdcch_re, n_cce)
