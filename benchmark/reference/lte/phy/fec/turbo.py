# Frozen copy of srslte_tpu_torch/phy/fec/turbo.py at commit e4337f4, unchanged but for this line.
"""LTE turbo code: QPP interleaver, PCCC encoder, rate matching (36.212 §5.1.3-4).

Reference behavior: lib/src/phy/fec/turbo/{tc_interl_lte.c, turbocoder.c,
rm_turbo.c}.  Construction:

* The RSC constituent encoder's feedback 1/(1 + D^2 + D^3) has an impulse
  response of period 7, so a batch encodes with one integer prefix sum per
  encoder and a few XORs (`_rsc_encode`), instead of the C library's
  byte-LUT serial pass (turbocoder.c:198+); no per-K generator matrix is
  kept.
* QPP interleaving and rate matching are precomputed gather index vectors per
  static (K, rv, E) bucket; soft-combining at RX is one masked gather-sum.
* Streams use the 36.212 d^(0)/d^(1)/d^(2) layout with the standard tail
  re-arrangement, stored concatenated as `dcat` of length 3*(K+4).

Trellis (turbocoder.c:113-145): state s=(s0,s1,s2), s0 newest;
in = u ^ s1 ^ s2 (g0 = 1+D^2+D^3), parity = in ^ s0 ^ s2 (g1 = 1+D+D^3),
next state (in, s0, s1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table
from .cbsegm import cb_index

TURBO_TAIL = 12  # total tail bits appended (4 per stream)
RATE = 3

# 36.212 Table 5.1.3-3 QPP parameters (standard constants; order matches cb_sizes())
F1 = np.array([
    3, 7, 19, 7, 7, 11, 5, 11, 7, 41, 103, 15, 9, 17, 9, 21, 101, 21, 57, 23, 13,
    27, 11, 27, 85, 29, 33, 15, 17, 33, 103, 19, 19, 37, 19, 21, 21, 115, 193, 21, 133, 81,
    45, 23, 243, 151, 155, 25, 51, 47, 91, 29, 29, 247, 29, 89, 91, 157, 55, 31, 17, 35, 227,
    65, 19, 37, 41, 39, 185, 43, 21, 155, 79, 139, 23, 217, 25, 17, 127, 25, 239, 17, 137, 215,
    29, 15, 147, 29, 59, 65, 55, 31, 17, 171, 67, 35, 19, 39, 19, 199, 21, 211, 21, 43, 149,
    45, 49, 71, 13, 17, 25, 183, 55, 127, 27, 29, 29, 57, 45, 31, 59, 185, 113, 31, 17, 171,
    209, 253, 367, 265, 181, 39, 27, 127, 143, 43, 29, 45, 157, 47, 13, 111, 443, 51, 51, 451, 257,
    57, 313, 271, 179, 331, 363, 375, 127, 31, 33, 43, 33, 477, 35, 233, 357, 337, 37, 71, 71, 37,
    39, 127, 39, 39, 31, 113, 41, 251, 43, 21, 43, 45, 45, 161, 89, 323, 47, 23, 47, 263,
], dtype=np.int64)

F2 = np.array([
    10, 12, 42, 16, 18, 20, 22, 24, 26, 84, 90, 32, 34, 108, 38, 120, 84, 44, 46, 48, 50,
    52, 36, 56, 58, 60, 62, 32, 198, 68, 210, 36, 74, 76, 78, 120, 82, 84, 86, 44, 90, 46,
    94, 48, 98, 40, 102, 52, 106, 72, 110, 168, 114, 58, 118, 180, 122, 62, 84, 64, 66, 68, 420,
    96, 74, 76, 234, 80, 82, 252, 86, 44, 120, 92, 94, 48, 98, 80, 102, 52, 106, 48, 110, 112,
    114, 58, 118, 60, 122, 124, 84, 64, 66, 204, 140, 72, 74, 76, 78, 240, 82, 252, 86, 88, 60,
    92, 846, 48, 28, 80, 102, 104, 954, 96, 110, 112, 114, 116, 354, 120, 610, 124, 420, 64, 66, 136,
    420, 216, 444, 456, 468, 80, 164, 504, 172, 88, 300, 92, 188, 96, 28, 240, 204, 104, 212, 192, 220,
    336, 228, 232, 236, 120, 244, 248, 168, 64, 130, 264, 134, 408, 138, 280, 142, 480, 146, 444, 120, 152,
    462, 234, 158, 80, 96, 902, 166, 336, 170, 86, 174, 176, 178, 120, 182, 184, 186, 94, 190, 480,
], dtype=np.int64)


@functools.lru_cache(maxsize=None)
def qpp_perm(k: int) -> np.ndarray:
    """pi[i] = (f1*i + f2*i^2) mod K; c'_i = c_{pi(i)} (tc_interl_lte.c:91)."""
    idx = cb_index(k)
    i = np.arange(k, dtype=np.int64)
    return ((F1[idx] * i + F2[idx] * i * i) % k).astype(np.int32)


@functools.lru_cache(maxsize=None)
def qpp_perm_inv(k: int) -> np.ndarray:
    p = qpp_perm(k)
    inv = np.empty_like(p)
    inv[p] = np.arange(k, dtype=np.int32)
    return inv


# ------------------------------------------------------------------- trellis
def _rsc_step(state: np.ndarray, u: np.ndarray):
    """One RSC step; state bits (s0,s1,s2) packed as s0*4+s1*2+s2."""
    s0, s1, s2 = (state >> 2) & 1, (state >> 1) & 1, state & 1
    fb = u ^ s1 ^ s2
    par = fb ^ s0 ^ s2
    return (fb << 2) | (s0 << 1) | s1, par


@functools.lru_cache(maxsize=1)
def trellis_tables():
    """NEXT[u,s], PAR[u,s] (shape [2,8]) and tail outputs per state.

    TAIL_X[s], TAIL_Z[s]: systematic/parity bits emitted when terminating from
    state s (input forced to feedback so register input is 0).
    """
    s = np.arange(8)
    nxt = np.zeros((2, 8), np.int32)
    par = np.zeros((2, 8), np.int32)
    for u in (0, 1):
        nxt[u], par[u] = _rsc_step(s, u)
    s0, s1, s2 = (s >> 2) & 1, (s >> 1) & 1, s & 1
    tail_x = s1 ^ s2  # systematic tail bit = feedback value
    tail_z = s0 ^ s2  # parity with register input 0
    tail_next = (s0 << 1) | s1  # shift in a zero
    return nxt, par, tail_x.astype(np.int32), tail_z.astype(np.int32), tail_next.astype(np.int32)


def _rsc_encode_np(bits: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host RSC: bits [..., K] -> (parity [..., K], tail_x [..., 3], tail_z [..., 3])."""
    nxt, par, tail_x, tail_z, tail_next = trellis_tables()
    state = np.zeros(bits.shape[:-1], np.int32)
    out = np.empty_like(bits)
    for i in range(bits.shape[-1]):
        u = bits[..., i].astype(np.int32)
        out[..., i] = par[u, state]
        state = nxt[u, state]
    txs, tzs = [], []
    for _ in range(3):
        txs.append(tail_x[state])
        tzs.append(tail_z[state])
        state = tail_next[state]
    assert np.all(state == 0)
    return out, np.stack(txs, -1).astype(bits.dtype), np.stack(tzs, -1).astype(bits.dtype)


def turbo_encode_np(bits: np.ndarray) -> np.ndarray:
    """Host turbo encoder: bits [..., K] -> dcat [..., 3*(K+4)].

    dcat = [d0 | d1 | d2] in the 36.212 §5.1.3.2.2 stream layout:
      d0 = x_0..x_{K-1}, x_K, z_{K+1}, x'_K, z'_{K+1}
      d1 = z_0..z_{K-1}, z_K, x_{K+2}, z'_K, x'_{K+2}
      d2 = z'_0..z'_{K-1}, x_{K+1}, z_{K+2}, x'_{K+1}, z'_{K+2}
    """
    k = bits.shape[-1]
    pi = qpp_perm(k)
    z, tx, tz = _rsc_encode_np(bits)
    zp, txp, tzp = _rsc_encode_np(bits[..., pi])
    d0 = np.concatenate([bits, tx[..., :1], tz[..., 1:2], txp[..., :1], tzp[..., 1:2]], -1)
    d1 = np.concatenate([z, tz[..., :1], tx[..., 2:3], tzp[..., :1], txp[..., 2:3]], -1)
    d2 = np.concatenate([zp, tx[..., 1:2], tz[..., 2:3], txp[..., 1:2], tzp[..., 2:3]], -1)
    return np.concatenate([d0, d1, d2], -1)


# Impulse response of the feedback 1/(1 + D^2 + D^3) over one period: the
# polynomial is primitive, so the response repeats every 7 steps.
_FB_TAPS = (0, 2, 3, 4)


def _rsc_encode(u):
    """RSC over the batch: u [..., K] int32 -> (parity [..., K], tail_x
    [..., 3], tail_z [..., 3]), equal to `_rsc_encode_np`.

    The feedback bit is fb_i = XOR of u_j over j <= i with h_{(i-j) mod 7} = 1,
    h = 1011100 (`_FB_TAPS`).  With S_j = u_j + u_{j-7} + u_{j-14} + ... (a
    prefix sum along each residue class mod 7, one integer `cumsum`),
    fb_i = S_i + S_{i-2} + S_{i-3} + S_{i-4} mod 2; the parity is
    fb_i ^ fb_{i-1} ^ fb_{i-3}.  No per-K table is kept."""
    k = u.shape[-1]
    lead = u.shape[:-1]
    rows = -(-k // 7)
    pad = u.new_zeros(lead + (rows * 7 - k,))
    s = torch.cumsum(torch.cat([u, pad], -1).reshape(lead + (rows, 7)), dim=-2,
                     dtype=torch.int32).reshape(lead + (rows * 7,))[..., :k]
    s = torch.cat([s.new_zeros(lead + (4,)), s], -1)  # S_j for j = -4 .. K-1
    fb = sum(s[..., 4 - t : 4 - t + k] for t in _FB_TAPS) & 1
    fbp = torch.cat([fb.new_zeros(lead + (3,)), fb], -1)  # fb_j for j = -3 .. K-1
    par = fb ^ fbp[..., 2 : 2 + k] ^ fbp[..., :k]
    # final state (s0, s1, s2) = (fb_{K-1}, fb_{K-2}, fb_{K-3}); the three
    # tail steps of `trellis_tables` from it
    s0, s1, s2 = fbp[..., -1], fbp[..., -2], fbp[..., -3]
    tail_x = torch.stack([s1 ^ s2, s0 ^ s1, s0], -1)
    tail_z = torch.stack([s0 ^ s2, s1, s0], -1)
    return par, tail_x, tail_z


def turbo_encode(bits, k: int, device=None):
    """Device turbo encoder: bits [..., K] {0,1} -> dcat [..., 3*(K+4)] uint8.

    Both constituent encoders by the closed form of `_rsc_encode` (integer
    prefix sums, exact); the interleaver is the cached QPP gather.  Equal to
    `turbo_encode_np` bit for bit."""
    bits = as_tensor(bits, device)
    u = bits.to(torch.int32)
    pi = table(("qpp", k), u.device, lambda: qpp_perm(k).astype(np.int64))
    z, tx, tz = _rsc_encode(u)
    zp, txp, tzp = _rsc_encode(u[..., pi])
    d0 = torch.cat([u, tx[..., :1], tz[..., 1:2], txp[..., :1], tzp[..., 1:2]], -1)
    d1 = torch.cat([z, tz[..., :1], tx[..., 2:3], tzp[..., :1], txp[..., 2:3]], -1)
    d2 = torch.cat([zp, tx[..., 1:2], tz[..., 2:3], txp[..., 1:2], tzp[..., 2:3]], -1)
    return torch.cat([d0, d1, d2], -1).to(torch.uint8)


# ------------------------------------------------------------- rate matching
NCOLS = 32
# 36.212 Table 5.1.4-1 inter-column permutation
RM_PERM = np.array([0, 16, 8, 24, 4, 20, 12, 28, 2, 18, 10, 26, 6, 22, 14, 30,
                    1, 17, 9, 25, 5, 21, 13, 29, 3, 19, 11, 27, 7, 23, 15, 31], np.int64)


@functools.lru_cache(maxsize=None)
def _wmap(k: int, f: int = 0):
    """Circular-buffer layout for CB size K with F filler bits.

    Returns (w_src, w_valid):
      w_src   int32 [3*Kp]: index into dcat (3*(K+4)) feeding each w position
      w_valid bool  [3*Kp]: False for dummy-padding and filler NULLs
    Implements 36.212 §5.1.4.1.1 sub-block interleavers + bit collection.
    """
    d = k + 4
    nrows = -(-d // NCOLS)
    kp = nrows * NCOLS
    nd = kp - d  # dummy bits prepended

    # v0/v1: write row-wise, permute columns, read column-wise
    pad_idx = np.concatenate([np.full(nd, -1, np.int64), np.arange(d)])
    mat = pad_idx.reshape(nrows, NCOLS)[:, RM_PERM]  # permute columns
    v01 = mat.T.reshape(-1)  # read column-wise
    # v2: pi(k) = (perm[k/R] + 32*(k mod R) + 1) mod Kp over the padded stream
    kk = np.arange(kp)
    pi2 = (RM_PERM[kk // nrows] + NCOLS * (kk % nrows) + 1) % kp
    v2 = pad_idx[pi2]

    # stream-local index -> dcat index; mark fillers NULL in d0/d1 (36.212 §5.1.3.2.2)
    def to_dcat(v, stream):
        src = np.where(v >= 0, v + stream * d, -1)
        valid = v >= 0
        if f > 0 and stream < 2:
            valid &= ~((v >= 0) & (v < f))
        return src, valid

    s0, m0 = to_dcat(v01, 0)
    s1, m1 = to_dcat(v01, 1)
    s2, m2 = to_dcat(v2, 2)

    # bit collection: w = [v0 ; interlaced(v1, v2)]
    w_src = np.concatenate([s0, np.stack([s1, s2], 1).reshape(-1)])
    w_valid = np.concatenate([m0, np.stack([m1, m2], 1).reshape(-1)])
    return w_src.astype(np.int32), w_valid, nrows, kp


def rm_k0(k: int, rv: int, n_cb: int | None = None) -> int:
    """Redundancy-version start offset (36.212 §5.1.4.1.2)."""
    d = k + 4
    nrows = -(-d // NCOLS)
    ncb = n_cb if n_cb is not None else 3 * nrows * NCOLS
    return nrows * (2 * -(-ncb // (8 * nrows)) * rv + 2)


@functools.lru_cache(maxsize=None)
def rm_indices(k: int, e: int, rv: int, f: int = 0, n_cb: int | None = None) -> np.ndarray:
    """Gather table: e_j = dcat[idx[j]], int32 [E].

    TX: gather; RX soft-combine: dcat_llr.at[idx].add(e_llr).
    n_cb limits the circular buffer (UE soft buffer size); default full.
    """
    w_src, w_valid, nrows, kp = _wmap(k, f)
    ncb = n_cb if n_cb is not None else 3 * kp
    k0 = rm_k0(k, rv, ncb)
    order = (k0 + np.arange(ncb)) % ncb
    sel = order[w_valid[order]]  # circular order, NULLs skipped
    if len(sel) == 0:
        raise ValueError("no valid bits in circular buffer")
    reps = -(-e // len(sel))
    idx_w = np.tile(sel, reps)[:e]
    return w_src[idx_w].astype(np.int32)


def rm_tx(dcat, k: int, e: int, rv: int, f: int = 0, n_cb: int | None = None,
          device=None):
    """Rate-match one bucket: dcat [..., 3*(K+4)] -> e bits [..., E] (gather)."""
    dcat = as_tensor(dcat, device)
    idx = table(("rm_idx", k, e, rv, f, n_cb), dcat.device,
                lambda: rm_indices(k, e, rv, f, n_cb).astype(np.int64))
    return dcat[..., idx]


@functools.lru_cache(maxsize=None)
def _rm_rx_inverse(k: int, e: int, rv: int, f: int, n_cb: int | None):
    """Inverse of rm_indices as a gather table [3*(K+4), R] (-1 padded).

    The soft combining is a masked gather-sum (R = max repetitions of any
    position, usually 1-2): deterministic, unlike a scatter-add with
    atomics."""
    idx = rm_indices(k, e, rv, f, n_cb)
    d = 3 * (k + 4)
    counts = np.bincount(idx, minlength=d)
    r = max(1, int(counts.max()))
    inv = np.full((d, r), -1, np.int64)
    fill = np.zeros(d, np.int64)
    for j, pos in enumerate(idx):
        inv[pos, fill[pos]] = j
        fill[pos] += 1
    return inv.astype(np.int32), r


def rm_rx(e_llr, k: int, rv: int, f: int = 0, n_cb: int | None = None,
          device=None):
    """Soft-combine LLRs back into the dcat layout: [..., E] -> [..., 3*(K+4)].

    Repeated transmissions of the same position accumulate (HARQ-style
    combining, rm_turbo.c:390).  Filler positions get a large negative LLR
    (known zero bits; LLR>0 means bit 1).
    """
    e_llr = as_tensor(e_llr, device)
    dev = e_llr.device
    e = e_llr.shape[-1]
    key = ("rm_rx", k, e, rv, f, n_cb)
    inv_t = table(key + ("inv",), dev, lambda: np.maximum(
        _rm_rx_inverse(k, e, rv, f, n_cb)[0], 0).astype(np.int64))
    mask = table(key + ("mask",), dev, lambda: (
        _rm_rx_inverse(k, e, rv, f, n_cb)[0] >= 0).astype(np.float32))
    gathered = e_llr[..., inv_t]  # [..., 3*(K+4), R]
    out = torch.sum(gathered * mask, dim=-1).to(e_llr.dtype)
    if f > 0:
        def fill():
            v = np.zeros(3 * (k + 4), np.float32)
            v[:f] = -1e4  # d0 fillers known 0
            return v
        out = out + table(key + ("fill",), dev, fill)
    return out
