"""NR Polar code: construction, encoder, rate matching, SC and CA-SCL decoders
(38.212 §5.3.1/§5.4.1).

Reference behavior: lib/src/phy/fec/polar/{polar_code.c, polar_encoder.c,
polar_rm.c, polar_decoder*.c}.  The universal reliability sequence Q^1024
(38.212 table 5.3.1.2-1) ships as polar_q1024.npy and the input interleaver
pattern (table 5.3.1.1-1) as polar_il_pattern.npy, this package's own copies;
per-N mother codes are subsequences of Q^1024.

The encoder is log2(N) butterfly XOR stages over the batch.  Both decoders
are the recursive f/g formulation with the tree walked in Python (static N):
every node is one elementwise step over the batch (and the list), so a
decode is a few launches per tree node.  The list decoder keeps the list as
an axis and threads the survivors' permutation back through the recursion
instead of copying decoder state; a permutation known to be the identity
(no information leaf below a node) is not applied.
"""

from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from .crc import gf2_matmul

_QPATH = os.path.join(os.path.dirname(__file__), "polar_q1024.npy")
_ILPATH = os.path.join(os.path.dirname(__file__), "polar_il_pattern.npy")
K_MAX_IL = 164

# 38.212 table 5.4.1.1-1 sub-block interleaver pattern
_P32 = np.array([0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19,
                 12, 20, 13, 21, 14, 22, 15, 23, 24, 25, 26, 28, 27, 29,
                 30, 31], np.int64)


@functools.lru_cache(maxsize=1)
def q1024() -> np.ndarray:
    return np.load(_QPATH).astype(np.int64)


@functools.lru_cache(maxsize=None)
def input_interleaver(k: int) -> np.ndarray:
    """38.212 §5.3.1.1 input interleaver for I_IL=1: out[i] = in[perm[i]].

    The 164-entry pattern (table 5.3.1.1-1, polar_il_pattern.npy) filtered
    to entries >= K_MAX - K, offset down (polar_interleaver.c:38).
    """
    pat = np.load(_ILPATH)
    sel = pat[pat >= K_MAX_IL - k] - (K_MAX_IL - k)
    assert len(sel) == k
    return sel.astype(np.int64)


@functools.lru_cache(maxsize=None)
def mother_code(n: int) -> np.ndarray:
    """Reliability order for N=2^n (subsequence rule, §5.3.1.2)."""
    q = q1024()
    return q[q < (1 << n)]


@functools.lru_cache(maxsize=None)
def blk_interleaver(n: int) -> np.ndarray:
    """J(i) sub-block interleaver for N=2^n (§5.4.1.1)."""
    nn = 1 << n
    i = np.arange(nn)
    b = _P32[32 * i // nn]
    return (b * (nn // 32) + i % (nn // 32)).astype(np.int64)


@dataclass(frozen=True)
class PolarCode:
    """Code construction for one (K, E) bucket.

    `with_pc=True` enables the UL parity-check bits (38.212 §5.3.1.2,
    polar_code.c get_code_params:124): nPC=3 when 18 <= K <= 25, with one
    minimum-row-weight PC bit (position 252/248 of the N=256 mother code)
    when E > K + 189.
    """

    K: int
    E: int
    n_max: int = 9  # 9 for DL, 10 for UL
    with_pc: bool = False

    @functools.cached_property
    def n(self) -> int:
        e, k = self.E, self.K
        cl = int(np.ceil(np.log2(e)))
        if e <= (9 * (1 << (cl - 1))) // 8 and k / e < 9 / 16:
            n1 = cl - 1
        else:
            n1 = cl
        n2 = int(np.ceil(np.log2(8 * k)))
        return max(min(n1, n2, self.n_max), 5)

    @property
    def N(self) -> int:
        return 1 << self.n

    @property
    def n_pc(self) -> int:
        return 3 if (self.with_pc and 18 <= self.K <= 25) else 0

    @property
    def n_wm_pc(self) -> int:
        return 1 if (self.n_pc and self.E > self.K + 189) else 0

    @functools.cached_property
    def _construction(self) -> tuple[np.ndarray, np.ndarray]:
        """(k_set_full sorted [K + nPC], pc_set sorted [nPC])."""
        nn, k, e = self.N, self.K, self.E
        frozen = np.zeros(nn, bool)
        jn = blk_interleaver(self.n)
        if e < nn:
            if 16 * k <= 7 * e:  # puncturing: first N-E interleaved + low idx
                frozen[jn[: nn - e]] = True
                if e >= 3 * nn // 4:
                    t = int(np.ceil(3 * nn / 4 - e / 2)) - 1
                else:
                    t = int(np.ceil(9 * nn / 16 - e / 4)) - 1
                frozen[: t + 1] = True
            else:  # shortening: last N-E interleaved positions
                frozen[jn[e:]] = True
        # most reliable K + nPC non-prefrozen positions carry data + PC
        order = mother_code(self.n)
        free = order[~frozen[order]]
        sel = free[-(k + self.n_pc):]
        pc = []
        if self.n_pc:
            # the (nPC - nWmPC) least reliable of the selection...
            pc = list(sel[: self.n_pc - self.n_wm_pc])
            if self.n_wm_pc:
                # ...plus the minimum-row-weight pick (polar_code.c:278-283)
                pc.append(252 if k <= 21 else 248)
        return (np.sort(sel).astype(np.int64),
                np.sort(np.array(pc, np.int64)))

    @functools.cached_property
    def frozen_mask(self) -> np.ndarray:
        """[N] bool: True = frozen (§5.3.1.2 incl. rate-matching pre-freeze)."""
        mask = np.ones(self.N, bool)
        mask[self._construction[0]] = False
        return mask

    @functools.cached_property
    def k_set(self) -> np.ndarray:
        """Information positions only (PC positions excluded), sorted."""
        full, pc = self._construction
        if not self.n_pc:
            return full
        return np.setdiff1d(full, pc)

    @functools.cached_property
    def pc_set(self) -> np.ndarray:
        return self._construction[1]

    @functools.cached_property
    def pc_matrix(self) -> np.ndarray:
        """[nPC, K] GF(2): PC value p = XOR of info bits q < p with
        q ≡ p (mod 5) — the 5-slot rotating register of chanalloc
        (polar_chanalloc.c:51-80) is linear in the message."""
        m = np.zeros((self.n_pc, self.K), np.uint8)
        for r, p in enumerate(self.pc_set):
            for c, q in enumerate(self.k_set):
                if q < p and (p - q) % 5 == 0:
                    m[r, c] = 1
        return m

    @functools.cached_property
    def leaf_kind(self) -> np.ndarray:
        """[N] int8: 0 = frozen, 1 = info, 2 = parity-check."""
        kind = np.zeros(self.N, np.int8)
        kind[self.k_set] = 1
        kind[self.pc_set] = 2
        return kind

    def _key(self, name: str):
        return ("polar", name, self.K, self.E, self.n_max, self.with_pc)

    def _index(self, name: str, build, device) -> torch.Tensor:
        return table(self._key(name), device, lambda: np.asarray(build(), np.int64))


def polar_transform(u):
    """Butterfly u -> u * G_N over GF(2): log2(N) vectorized stages."""
    x = u.to(torch.uint8)
    n = x.shape[-1]
    s = 1
    while s < n:
        x = x.reshape(x.shape[:-1] + (n // (2 * s), 2, s))
        x = torch.cat([x[..., 0, :] ^ x[..., 1, :], x[..., 1, :]], dim=-1)
        x = x.reshape(x.shape[:-2] + (n,))
        s *= 2
    return x


def polar_encode(bits, code: PolarCode, device=None):
    """bits [..., K] -> rate-matched codeword bits [..., E] uint8."""
    bits = as_tensor(bits, device)
    dev = bits.device
    u = torch.zeros(bits.shape[:-1] + (code.N,), dtype=torch.uint8, device=dev)
    u[..., code._index("k_set", lambda: code.k_set, dev)] = bits.to(torch.uint8)
    if code.n_pc:
        pc = gf2_matmul(bits, code._key("pc_matrix"), lambda: code.pc_matrix.T)
        u[..., code._index("pc_set", lambda: code.pc_set, dev)] = pc.to(torch.uint8)
    x = polar_transform(u)
    y = x[..., code._index("blk_il", lambda: blk_interleaver(code.n), dev)]
    nn, e = code.N, code.E
    if e >= nn:  # repetition
        reps = -(-e // nn)
        return y.repeat((1,) * (y.ndim - 1) + (reps,))[..., :e]
    if 16 * code.K <= 7 * e:  # puncturing: drop the first N-E
        return y[..., nn - e :]
    return y[..., :e]  # shortening


def polar_rm_rx(e_llr, code: PolarCode, shortened_val: float = -1e4, device=None):
    """LLRs [..., E] -> mother-code LLRs [..., N] (positive => bit 1).

    Repetition sums every copy of a position, chunk by chunk in the order
    they were sent (slice adds: no index repeats within one add)."""
    e_llr = as_tensor(e_llr, device)
    nn, e = code.N, code.E
    y = e_llr.new_zeros(e_llr.shape[:-1] + (nn,))
    if e >= nn:
        for r in range(-(-e // nn)):
            chunk = e_llr[..., r * nn : (r + 1) * nn]
            y[..., : chunk.shape[-1]] += chunk
    elif 16 * code.K <= 7 * e:
        y[..., nn - e :] = e_llr  # punctured front: LLR 0
    else:
        y[..., :e] = e_llr
        y[..., e:] = shortened_val  # shortened tail: known 0
    inv = code._index("blk_il_inv", lambda: np.argsort(blk_interleaver(code.n)), y.device)
    return y[..., inv]


def _take(x, perm):
    """x [B, L, ...] with the paths reordered by perm [B, L] (None: as is)."""
    if perm is None:
        return x
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[rows, perm]


def _f(la, lb):
    return torch.sign(la) * torch.sign(lb) * torch.minimum(torch.abs(la), torch.abs(lb))


def _g(la, lb, x):
    return lb + (1.0 - 2.0 * x.to(torch.float32)) * la


def polar_decode_list(llr, code: PolarCode, L: int = 8, device=None):
    """Batched CA-SCL-ready SCL decode: llr [..., E] -> candidates [..., L, K].

    Reference behavior: lib/src/phy/fec/polar/polar_decoder_ssc_*.c list
    variants.  The list is an axis beside the batch; path forking at an
    information leaf keeps the L smallest of the 2L path metrics, the lower
    index first among equal metrics (dead paths start at +inf, so ties occur
    at every early leaf and wherever an LLR is 0), by a stable sort.  The
    survivors' permutation is threaded back through the recursion.
    Candidates are ordered by path metric (best first, stable); callers check
    the outer CRC per candidate (CA-SCL selection).
    """
    llr = as_tensor(llr, device)
    lead = llr.shape[:-1]
    ln = polar_rm_rx(llr.reshape((-1, llr.shape[-1])), code)
    dev = ln.device
    B = ln.shape[0]
    l0 = -ln.to(torch.float32)  # positive => bit 0 internally
    kind = code.leaf_kind  # 0 frozen / 1 info / 2 parity-check
    m0 = torch.full((B, L), float("inf"), dtype=torch.float32, device=dev)
    m0[:, 0] = 0.0
    # 5-slot PC shift register per path (38.212 §5.3.1.2; rotates at every
    # leaf, folds info bits in, emits at PC leaves)
    reg0 = torch.zeros((B, L, 5), dtype=torch.uint8, device=dev)
    zero = torch.zeros((B, L, 1), dtype=torch.uint8, device=dev)

    def dec(l, knd, m, reg):
        """l [B, L, n], m [B, L], reg [B, L, 5] -> (u, x, m', perm, reg')."""
        n = l.shape[-1]
        if n == 1:
            lf = l[..., 0]
            if code.n_pc:
                reg = torch.roll(reg, -1, dims=-1)
            if knd[0] == 0:  # frozen
                return zero, zero, m + torch.relu(-lf), None, reg
            if knd[0] == 2:  # parity check: bit forced to register output
                b = reg[..., 0]
                pen = torch.relu(lf * (2.0 * b.to(torch.float32) - 1.0))
                return b[..., None], b[..., None], m + pen, None, reg
            both = torch.cat([m + torch.relu(-lf), m + torch.relu(lf)], dim=-1)  # [B, 2L]
            idx = torch.sort(both, dim=-1, stable=True).indices[:, :L]
            b = (idx >= L).to(torch.uint8)
            perm = idx % L
            if code.n_pc:
                reg = _take(reg, perm)
                reg[..., 0] ^= b
            return b[..., None], b[..., None], torch.gather(both, 1, idx), perm, reg
        half = n // 2
        la, lb = l[..., :half], l[..., half:]
        u1, x1, m, p1, reg = dec(_f(la, lb), knd[:half], m, reg)
        la, lb = _take(la, p1), _take(lb, p1)
        u2, x2, m, p2, reg = dec(_g(la, lb, x1), knd[half:], m, reg)
        u1, x1 = _take(u1, p2), _take(x1, p2)
        perm = p2 if p1 is None else (p1 if p2 is None else torch.gather(p1, 1, p2))
        return torch.cat([u1, u2], -1), torch.cat([x1 ^ x2, x2], -1), m, perm, reg

    u_hat, _, metric, _, _ = dec(l0[:, None, :].expand(B, L, code.N), kind, m0, reg0)
    order = torch.argsort(metric, dim=-1, stable=True)
    out = _take(u_hat, order)[..., code._index("k_set", lambda: code.k_set, dev)]
    return out.reshape(lead + (L, code.K))


def polar_decode(llr, code: PolarCode, device=None):
    """Batched SC decode: llr [..., E] (positive => bit 1) -> bits [..., K].

    The list decoder at L=1: its stable sort keeps bit 0 where the leaf LLR
    is >= 0, the reference's SC decision, and it carries the PC register.
    """
    return polar_decode_list(llr, code, L=1, device=device)[..., 0, :]
