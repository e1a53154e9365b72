"""NR LDPC: BG1/BG2 encoder, layered min-sum decoder, rate matching
(38.212 §5.3.2/§5.4.2).

Reference behavior: lib/src/phy/fec/ldpc/{ldpc_encoder.c, ldpc_decoder.c,
ldpc_rm.c, base_graph.c}; the base-graph tables are the 3GPP constants,
shipped as ldpc_bg.npz (this package's own copy).

- Every cyclic shift is a gather: for a base row, the index table [deg, Zc]
  of its lifted edges, ``c * Zc + (k + shift) mod Zc``, is built once per
  (bg, Zc) and kept on the device.  A row update reads its edges with one
  gather and writes them back through the same index.
- The encoder computes the core parities by the double-diagonal
  back-substitution (the sum of the 4 core rows' p1 column collapses to one
  monomial, asserted when the graph is built), then the extension parities
  by accumulation; all rows' systematic sums are one gather.
- The decoder is layered normalized min-sum, the 46/42 base rows in order,
  the iterations a Python loop.
- Rate matching is a gather (TX) and a scatter-add that sums repeated
  positions (RX), with rv-dependent k0 and filler bits skipped.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table

VOID = 0xFFFF
_LS_A = (2, 3, 5, 7, 9, 11, 13, 15)

_NPZ = os.path.join(os.path.dirname(__file__), "ldpc_bg.npz")


@functools.lru_cache(maxsize=1)
def _tables():
    z = np.load(_NPZ)
    return {1: z["bg1"].astype(np.int64), 2: z["bg2"].astype(np.int64)}


def lifting_index(zc: int) -> int:
    """Lifting-size set index i_LS (38.212 table 5.3.2-1)."""
    a = zc
    while a % 2 == 0 and a > 15:
        a //= 2
    for i, base in enumerate(_LS_A):
        x = base
        while x <= 384:
            if x == zc:
                return i
            x *= 2
    raise ValueError(f"invalid lifting size {zc}")


def valid_lifting_sizes() -> list:
    out = set()
    for a in _LS_A:
        x = a
        while x <= 384:
            out.add(x)
            x *= 2
    return sorted(out)


@dataclass(frozen=True)
class LdpcGraph:
    """Static structure for one (bg, Zc) bucket."""

    bg: int
    zc: int

    @property
    def n_sys_blocks(self) -> int:
        return 22 if self.bg == 1 else 10

    @property
    def m_blocks(self) -> int:
        return 46 if self.bg == 1 else 42

    @property
    def n_blocks(self) -> int:
        return self.n_sys_blocks + self.m_blocks

    @property
    def k(self) -> int:
        return self.n_sys_blocks * self.zc

    @property
    def n_full(self) -> int:
        return self.n_blocks * self.zc

    @functools.cached_property
    def shifts(self) -> np.ndarray:
        """[m_blocks, n_blocks] shift mod Zc, -1 where no edge."""
        t = _tables()[self.bg][lifting_index(self.zc)]
        s = np.where(t == VOID, -1, t % self.zc)
        return s.astype(np.int64)

    @functools.cached_property
    def rows(self) -> tuple:
        """Per base row: (cols [deg], shifts [deg])."""
        out = []
        for r in range(self.m_blocks):
            cols = np.where(self.shifts[r] >= 0)[0]
            out.append((cols.astype(np.int64), self.shifts[r][cols]))
        return tuple(out)

    @functools.cached_property
    def p1_inverse_shift(self) -> int:
        """Solve the core: sum of the 4 core rows' p1-column monomials must
        collapse to a single x^s (the 38.212 design property)."""
        kb = self.n_sys_blocks
        poly = np.zeros(self.zc, np.int64)
        for r in range(4):
            s = self.shifts[r, kb]
            if s >= 0:
                poly[s] ^= 1
        nz = np.where(poly)[0]
        assert len(nz) == 1, "core p1 column must sum to one monomial"
        return int(nz[0])

    def edge_index(self, r: int, cols=None, col0: int = 0) -> np.ndarray:
        """[deg, Zc] flat positions of row r's lifted edges (only the columns
        that the predicate `cols` keeps, when given), counted from column
        `col0`: edge i at k reads ``(col_i - col0) * Zc + (k + shift_i) mod
        Zc``, the QC rotation of the reference's ``roll(x, -shift)``."""
        c, s = self.rows[r]
        keep = np.ones(len(c), bool) if cols is None else cols(c)
        k = np.arange(self.zc)
        return ((c[keep, None] - col0) * self.zc
                + (k[None, :] + s[keep, None]) % self.zc)

    def padded_edges(self, rows, cols, col0: int, pad: int) -> np.ndarray:
        """`edge_index` of each of `rows`, padded to one width with
        ``pad + k`` (the caller appends a zero block at `pad`):
        [len(rows), width, Zc] int64."""
        idx = [self.edge_index(r, cols, col0) for r in rows]
        width = max(1, max(len(i) for i in idx))
        out = np.broadcast_to(pad + np.arange(self.zc), (len(rows), width, self.zc)).copy()
        for j, i in enumerate(idx):
            out[j, : len(i)] = i
        return out

    def table(self, name: str, device, build) -> torch.Tensor:
        return table(("ldpc", name, self.bg, self.zc), device, build)


def _rot(x, shift: int):
    """QC rotation: out[k] = x[(k + shift) mod Zc] on the last axis."""
    return torch.roll(x, -shift, dims=-1)


def ldpc_encode(bits, graph: LdpcGraph, device=None):
    """bits [..., K] {0,1} -> full codeword [..., n_full] uint8.

    Filler handling is the caller's job (set filler bits to 0).  The
    transmitted part is codeword[..., 2*Zc:] (first 2 blocks punctured).
    """
    bits = as_tensor(bits, device)
    dev = bits.device
    zc, kb, mb = graph.zc, graph.n_sys_blocks, graph.m_blocks
    lead = bits.shape[:-1]
    s = bits.reshape(lead + (graph.k,)).to(torch.uint8)
    s0 = torch.cat([s, s.new_zeros(lead + (zc,))], -1)  # a zero block to pad with

    # lambda_r over the systematic columns of every row: one gather, one sum
    idx = graph.table("lam", dev, lambda: graph.padded_edges(
        range(mb), lambda c: c < kb, 0, graph.k))
    lam = s0[..., idx].sum(-2, dtype=torch.uint8) & 1  # [..., m_blocks, Zc]

    # core parities p1..p4 (double-diagonal back-substitution)
    sum_core = lam[..., 0, :] ^ lam[..., 1, :] ^ lam[..., 2, :] ^ lam[..., 3, :]
    solved = {kb: _rot(sum_core, -graph.p1_inverse_shift)}
    for r in range(3):  # rows 0..2 each introduce one new parity col
        cols, shs = graph.rows[r]
        acc = lam[..., r, :]
        unknown = None
        for c, sh in zip(cols, shs):
            if c < kb:
                continue
            if c in solved:
                acc = acc ^ _rot(solved[c], int(sh))
            else:
                assert unknown is None
                unknown = (c, int(sh))
        c, sh = unknown
        solved[c] = _rot(acc, -sh)
    core = torch.cat([solved[kb + i] for i in range(4)], -1)  # [..., 4 Zc]

    # extension parities: row r >= 4 has identity on col kb+r
    core0 = torch.cat([core, core.new_zeros(lead + (zc,))], -1)
    pick = graph.table("ext", dev, lambda: graph.padded_edges(
        range(4, mb), lambda c: (c >= kb) & (c < kb + 4), kb, 4 * zc))
    ext = lam[..., 4:, :] ^ (core0[..., pick].sum(-2, dtype=torch.uint8) & 1)
    return torch.cat([s, core, ext.reshape(lead + (-1,))], -1)


def ldpc_check(cw, graph: LdpcGraph, device=None):
    """Parity check: True where H*c == 0."""
    cw = as_tensor(cw, device)
    lead = cw.shape[:-1]
    c0 = torch.cat([cw, cw.new_zeros(lead + (graph.zc,))], -1).to(torch.uint8)
    idx = graph.table("check", cw.device, lambda: graph.padded_edges(
        range(graph.m_blocks), None, 0, graph.n_full))
    syn = c0[..., idx].sum(-2, dtype=torch.uint8) & 1  # [..., m_blocks, Zc]
    return ~torch.any(syn.reshape(lead + (-1,)) != 0, dim=-1)


MINSUM_SCALE = 0.75


def ldpc_decode(llr, graph: LdpcGraph, n_iter: int = 8, device=None):
    """Layered normalized min-sum. llr [..., n_full] (positive => bit 1).

    Punctured/shortened positions carry 0 LLR; filler positions should carry
    a large NEGATIVE LLR (known 0 bits).  Returns (hard [..., K] uint8,
    ok [...] parity check).

    Each base row, in order: one gather of its lifted edges, the check
    update in the reference's float32 order, one scatter back.  Zero counts
    as +1 in the sign product; where two edges share the smallest magnitude
    both are masked, so the second minimum is the next distinct magnitude
    (the reference's rule, not textbook min-sum).
    """
    llr = as_tensor(llr, device)
    dev = llr.device
    lead = llr.shape[:-1]
    # decoder convention: positive => bit 0 (classic min-sum); flip in/out
    v = (-llr).reshape((-1, graph.n_full)).to(torch.float32).contiguous()
    idx = [graph.table(f"row{r}", dev, lambda r=r: graph.edge_index(r).reshape(-1))
           for r in range(graph.m_blocks)]
    msgs = [None] * graph.m_blocks
    for _ in range(n_iter):
        for r in range(graph.m_blocks):
            deg = len(graph.rows[r][0])
            t = v[:, idx[r]].reshape(-1, deg, graph.zc)
            if msgs[r] is not None:
                t = t - msgs[r]
            sz = torch.sign(t) + (t == 0)
            sgn = torch.prod(sz, dim=-2, keepdim=True)
            a = torch.abs(t)
            m1 = torch.amin(a, dim=-2, keepdim=True)
            at_min = a == m1
            m2 = torch.amin(torch.where(at_min, float("inf"), a), dim=-2, keepdim=True)
            mins = torch.where(at_min, m2, m1)
            new = MINSUM_SCALE * (sgn * sz) * mins
            msgs[r] = new
            v.index_copy_(1, idx[r], (t + new).reshape(-1, deg * graph.zc))
    hard = (v < 0).to(torch.uint8).reshape(lead + (graph.n_full,))
    ok = ldpc_check(hard, graph)
    return hard[..., : graph.k], ok


# ------------------------------------------------------------ rate matching
def rm_k0(graph: LdpcGraph, rv: int, n_cb: int | None = None) -> int:
    """38.212 table 5.4.2.1-2 starting positions."""
    zc = graph.zc
    ncb = n_cb if n_cb is not None else graph.n_full - 2 * zc
    if graph.bg == 1:
        num, den = {0: 0, 1: 17, 2: 33, 3: 56}[rv], 66
    else:
        num, den = {0: 0, 1: 13, 2: 25, 3: 43}[rv], 50
    return (num * ncb // (den * zc)) * zc


@functools.lru_cache(maxsize=None)
def ldpc_rm_indices(graph: LdpcGraph, e: int, rv: int, qm: int,
                    k_prime: int) -> np.ndarray:
    """Gather table [E] into the full codeword [n_full].

    k_prime: number of non-filler systematic bits (fillers occupy
    [k_prime, K) and are skipped by the circular buffer).
    """
    zc = graph.zc
    # circular buffer = codeword minus the first 2 punctured blocks
    buf = np.arange(2 * zc, graph.n_full)
    filler = (buf >= k_prime) & (buf < graph.k)
    k0 = rm_k0(graph, rv)
    order = np.roll(buf, -k0)
    valid = order[~np.roll(filler, -k0)]
    reps = -(-e // len(valid))
    sel = np.tile(valid, reps)[:e]
    # bit interleaver (38.212 §5.4.2.2): write row-wise [E/Qm, Qm], read
    # column-wise... spec: e_interleaved[i + j*Qm] = e[i*(E/Qm) + j]
    rows = e // qm
    j, i = np.meshgrid(np.arange(rows), np.arange(qm), indexing="ij")
    perm = (i * rows + j).reshape(-1)
    return sel[perm].astype(np.int32)


def _rm_index(graph: LdpcGraph, e: int, rv: int, qm: int, k_prime: int, device):
    return table(("ldpc_rm", graph.bg, graph.zc, e, rv, qm, k_prime), device,
                 lambda: ldpc_rm_indices(graph, e, rv, qm, k_prime).astype(np.int64))


def ldpc_rm_tx(cw, graph: LdpcGraph, e: int, rv: int, qm: int, k_prime: int,
               device=None):
    cw = as_tensor(cw, device)
    return cw[..., _rm_index(graph, e, rv, qm, k_prime, cw.device)]


def ldpc_rm_rx(e_llr, graph: LdpcGraph, rv: int, qm: int, k_prime: int,
               fill_val: float = -1e4, device=None):
    """Soft-combine into full-codeword LLRs (fillers get known-0 prior).

    A position sent more than once (E longer than the circular buffer) gets
    the sum of its copies: a scatter-add, `index_add_`."""
    e_llr = as_tensor(e_llr, device)
    e = e_llr.shape[-1]
    idx = _rm_index(graph, e, rv, qm, k_prime, e_llr.device)
    flat = e_llr.reshape((-1, e))
    out = flat.new_zeros((flat.shape[0], graph.n_full)).index_add_(1, idx, flat)
    out = out.reshape(e_llr.shape[:-1] + (graph.n_full,))
    if k_prime < graph.k:
        fill = torch.zeros(graph.n_full, dtype=e_llr.dtype, device=e_llr.device)
        fill[k_prime : graph.k] = fill_val
        out = out + fill
    return out
