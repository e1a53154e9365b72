"""Windowed max-log-MAP SISO: CUDA kernel wrapper and plain PyTorch version.

Replaces the Pallas kernel ``srslte_tpu/ops/tdec_pallas.py`` ``_siso_kernel``
(reached through ``siso_from_windows``) together with the window-building
glue around it (``prepare_windows``, ``prepare_windows_roll``,
``prepare_beta_init``, ``take_windows``): `siso_windowed` computes what the
kernel and the glue compute together, straight from the [B, K] LLR tensors.
Both of that kernel's runs are here, chosen by the input dtype: float32, and
the 16-bit run (``dtype=bfloat16``) that the JAX package takes on its
accelerator, whose metrics are re-pinned to state 0 after every step.

What bounds it on an H100: the function moves 3 values per trellis position
(two inputs, one output; 4 bytes each in float32, 2 in bfloat16) and does
about 85 adds and max per position (about 110 with the bfloat16
re-pinning), so its floor is set by bytes.  What stands between a kernel and
that floor is the T + L dependent steps of every window and the room on chip
for the windows in flight.  The design of ``csrc/tdec_siso.cu``: one lane
per trellis state, a group of 8 lanes per window (float32) or per pair of
windows packed in ``__nv_bfloat162`` (16 bits), the metrics exchanged by
warp shuffles; alpha and beta in one merged loop; both metric histories in
shared memory, only the L x 8 metrics that are read back; the inputs loaded
two chunks of 8 steps ahead into a ring of gammas in shared memory, the QPP
interleave (``perm``) gathered once per position; the LLRs of 8 steps
finished together by a transposed reduction over the group.  Nothing but
the inputs and the output goes through device memory.  `siso_plan`
computes the launch geometry (groups, blocks, dynamic shared bytes, the
pairing of 16-bit windows) and refuses a shape whose history does not fit
in a block's shared memory.

Measured with ``chip_smoke.py`` and ``ops/siso_variants.py`` on an NVIDIA
H100 80GB HBM3 at 700 W, at L 256, T 32: 96 registers per thread in float32
without ``perm`` and 118-120 with it, 120-124 in 16 bits, no spill; 37,888
shared bytes per block of 32 threads, 6 resident blocks, so 24 windows per
SM in float32 and 48 in 16 bits.  At the DL path's shape (B 1408, K 5824)
the float32 kernel takes 0.263 ms (11 % of its byte bound) and the 16-bit
one 0.203 ms (7 %), the mean of a launch with ``perm`` and one without.
Padding a block's shared memory so that only 3 blocks are resident makes it
1.5-1.6 times slower, but a variant with twice the windows in flight and
recomputed histories was slower still: at 6 blocks it is near the
throughput of its shuffles and shared-memory accesses per window step.

`siso_windowed_plain` repeats the same arithmetic with PyTorch ops (a Python
loop over the T + L steps on [8, N] tensors), in the input's dtype, one
PyTorch op per kernel op: each bfloat16 op rounds once, as the kernel's
intrinsics do, so the two agree exactly.  It is what runs for a CPU tensor,
and what the kernel is held against on the card.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from ..utils import jit
from . import _build

NEG = -1e9

LANES_PER_GROUP = 8  # one lane per trellis state
GROUPS_PER_BLOCK = 4  # one warp per block
SMEM_PER_BLOCK = 232448  # shared memory one block may use on sm_90 (MAX_SMEM in the source)
METRIC_WORD = 4  # bytes of a lane's metric word: one float32, or a bfloat16 pair
RING_WORDS = 2 * LANES_PER_GROUP * 4  # input ring per group: 2 sides x 8 steps x 2 gamma pairs


@functools.lru_cache(maxsize=1)
def _trellis_index_tables():
    """Index tables of the statically known trellis, from its closed forms.

    alpha: into state sp dropping bit b, predecessor ((sp & 3) << 1) | b with
    gamma index (u << 1) | p; beta: from state s with input 0, next state n0
    and parity p0; input 1 gives n0 ^ 4 and p0 ^ 1.
    """
    sp = np.arange(8)
    pred = np.stack([((sp & 3) << 1) | b for b in (0, 1)], axis=1)  # [8, 2]
    gidx = np.stack([((((sp >> 2) ^ sp ^ b) & 1) << 1) | (((sp >> 2) ^ (sp >> 1) ^ b) & 1)
                     for b in (0, 1)], axis=1)  # [8, 2]
    n0 = (sp >> 1) | (((sp ^ (sp >> 1)) & 1) << 2)
    p0 = ((sp >> 1) ^ (sp >> 2)) & 1
    return (pred.astype(np.int64), gidx.astype(np.int64), n0.astype(np.int64),
            p0.astype(np.int64), (n0 ^ 4).astype(np.int64), (2 | (p0 ^ 1)).astype(np.int64))


def siso_windowed_plain(sys_apr, par, beta_init, L: int, T: int,
                        emit_ext: bool = False, perm=None):
    """Plain PyTorch version of `siso_windowed` (same arguments, same result).

    B*W windows run in parallel, each over the positions wL-T .. wL+L+T-1 of
    its code block: alpha trains on the T positions before the window (window
    0 starts exactly in state 0, through inactive halo steps), beta on the T
    positions after it (the last window starts from `beta_init`, the tail
    termination).  State-major layout [8, N].  Metrics are in the inputs'
    dtype: float32 runs without normalisation (its headroom covers L + T
    steps); bfloat16 re-pins both metric vectors to state 0 after every step.
    """
    B, K = sys_apr.shape
    dev, dt = sys_apr.device, sys_apr.dtype
    norm = dt == torch.bfloat16
    neg = torch.tensor(NEG, dtype=torch.float32).to(dt).to(dev)
    W = -(-K // L)  # the last window may be partially inactive (K % L != 0)
    N = B * W
    pred, gidx, n0, p0, n1, g1i = (torch.as_tensor(t, device=dev)
                                   for t in _trellis_index_tables())
    if perm is not None:
        sys_apr = sys_apr[:, perm.to(torch.int64)]
    w_starts = np.arange(W) * L

    def window_inputs(pos):
        idx = torch.as_tensor(np.clip(pos, 0, K - 1).astype(np.int64), device=dev)
        act = torch.as_tensor((pos >= 0) & (pos <= K - 1), device=dev)  # [W, LT]
        lt = pos.shape[-1]
        zero = torch.zeros((), dtype=dt, device=dev)
        sa = torch.where(act, sys_apr[:, idx], zero).reshape(N, lt).T  # [LT, N]
        pr = torch.where(act, par[:, idx], zero).reshape(N, lt).T
        live = act.expand(B, W, lt).reshape(N, lt).T
        return sa, pr, live

    def gammas(sa, pr):
        return torch.stack([torch.zeros_like(sa), pr, sa, sa + pr])  # [4, N]

    def pin(m):  # m[s] - m[0]: state 0 exactly 0
        return m - m[0:1] if norm else m

    # --- alpha: positions wL-T .. wL+L-1 ------------------------------------
    sa_a, pr_a, live_a = window_inputs(w_starts[:, None] + np.arange(-T, L)[None, :])
    a = torch.zeros((8, N), dtype=dt, device=dev)
    first = (torch.arange(N, device=dev) % W) == 0  # window-0 lanes
    a[1:, first] = neg
    alphas = torch.empty((T + L, 8, N), dtype=dt, device=dev)
    for t in range(T + L):
        alphas[t] = a  # alpha BEFORE this step
        g = gammas(sa_a[t], pr_a[t])
        new = torch.maximum(a[pred[:, 0]] + g[gidx[:, 0]], a[pred[:, 1]] + g[gidx[:, 1]])
        a = pin(torch.where(live_a[t], new, a))  # inactive: carry through

    # --- beta + llr: positions wL+L+T-1 down to wL ---------------------------
    sa_b, pr_b, live_b = window_inputs(w_starts[:, None] + np.arange(L + T)[None, :])
    b0 = torch.zeros((B, W, 8), dtype=dt, device=dev)
    b0[:, W - 1] = beta_init
    b = b0.reshape(N, 8).T.contiguous()  # [8, N]; uniform 0 for training windows
    llr_w = torch.empty((L, N), dtype=dt, device=dev)
    for t in range(L + T - 1, -1, -1):
        g = gammas(sa_b[t], pr_b[t])
        r0 = b[n0] + g[p0]  # u=0: gamma = p*pr
        r1 = b[n1] + g[g1i]  # u=1: gamma = sa + p*pr
        if t < L:
            alpha_k = alphas[T + t]
            m0 = torch.max(alpha_k + r0, dim=0).values
            m1 = torch.max(alpha_k + r1, dim=0).values
            llr_w[t] = (m1 - m0 - sa_b[t]) if emit_ext else (m1 - m0)
        b = pin(torch.where(live_b[t], torch.maximum(r0, r1), b))
    out = llr_w.reshape(L, B, W).permute(1, 2, 0).reshape(B, W * L)
    return out[:, :K].contiguous()


def _check(sys_apr, par, beta_init, L, T, perm):
    B, K = sys_apr.shape if sys_apr.dim() == 2 else (None, None)
    if B is None:
        raise ValueError(f"sys_apr must be [B, K], got {tuple(sys_apr.shape)}")
    if par.shape != sys_apr.shape or beta_init.shape != (B, 8):
        raise ValueError(
            f"par must be {tuple(sys_apr.shape)} and beta_init {(B, 8)}, got "
            f"{tuple(par.shape)} and {tuple(beta_init.shape)}")
    if L < 1 or T < 0:
        raise ValueError(f"invalid window L={L}, T={T}")
    tensors = [sys_apr, par, beta_init] + ([perm] if perm is not None else [])
    for t in tensors:
        if t.device != sys_apr.device:
            raise ValueError("all tensors must lie on one device")
        if not t.is_contiguous():
            raise ValueError("tensors must be contiguous")
    if sys_apr.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"LLRs must be float32 or bfloat16, got {sys_apr.dtype}")
    if par.dtype != sys_apr.dtype or beta_init.dtype != sys_apr.dtype:
        raise TypeError(f"sys_apr, par and beta_init must share one dtype, got "
                        f"{sys_apr.dtype}, {par.dtype}, {beta_init.dtype}")
    if perm is not None and (perm.dtype != torch.int32 or perm.shape != (K,)):
        raise TypeError(f"perm must be int32 [{K}], got {perm.dtype} {tuple(perm.shape)}")


class SisoPlan(NamedTuple):
    """Launch geometry of the SISO kernel for one shape."""

    windows: int  # B * W windows of L positions
    windows_per_group: int  # 1 in float32; 2 in 16 bits, one __nv_bfloat162 pair
    groups: int  # groups of LANES_PER_GROUP lanes, one per trellis state
    blocks: int  # of GROUPS_PER_BLOCK groups
    threads: int  # per block
    smem_bytes: int  # dynamic shared memory per block: histories, systematic buffer, gamma ring


def siso_plan(B: int, K: int, L: int, T: int, bf16: bool) -> SisoPlan:
    """The kernel's launch geometry for [B, K] inputs and windows of L with
    T-step halos; raises ValueError for a shape that does not fit.

    Group g of block x holds the windows (x * GROUPS_PER_BLOCK + g) * wpg + h,
    h < wpg, of the B * W windows numbered b * W + w: in 16 bits, windows 2m
    and 2m + 1 share a lane's __nv_bfloat162 (a pair may span two code
    blocks), and an odd count leaves the last pair's high half a dummy.  The
    blocks are as few as cover every window, which the kernel's launch
    checks.  Shared memory per group, in metric words: the history, L steps
    of 8; the systematic values of the L window positions; the input ring,
    8 steps of 2 gamma pairs for each side.  The launch refuses a plan whose
    shared bytes are not exactly what the kernel's layout uses."""
    W = -(-K // L)
    N = B * W
    wpg = 2 if bf16 else 1
    groups = -(-N // wpg)
    blocks = -(-groups // GROUPS_PER_BLOCK)
    smem = GROUPS_PER_BLOCK * (L * (LANES_PER_GROUP + 1) + RING_WORDS) * METRIC_WORD
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"window L={L}, T={T} needs {smem} bytes of shared memory per block, "
                         f"more than the {SMEM_PER_BLOCK} a block may use")
    return SisoPlan(N, wpg, groups, blocks, GROUPS_PER_BLOCK * LANES_PER_GROUP, smem)


@functools.lru_cache(maxsize=None)
def _lib(entry: str):
    return _entry(_build.load("tdec_siso"), entry)


def _entry(lib: ctypes.CDLL, entry: str):
    fn = getattr(lib, entry)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def siso_windowed(sys_apr, par, beta_init, L: int, T: int,
                  emit_ext: bool = False, perm=None):
    """One max-log-MAP pass over windows: LLRs (or extrinsics) [B, K].

    sys_apr [B, K]: systematic + a-priori LLR (positive => bit 1); par [B, K]:
    parity LLR; beta_init [B, 8]: beta after the last position, from the tail
    (`tdec._tail_beta`).  emit_ext returns llr - sys_apr (after `perm`).  perm
    (int32 [K]) reads the systematic stream as sys_apr[:, perm].  The three
    LLR tensors are all float32 or all bfloat16; the result has their dtype.

    A CUDA tensor goes to the kernel, under `siso_plan`'s geometry (which
    refuses a window too long for a block's shared memory); a CPU tensor to
    `siso_windowed_plain`.  Launches are counted per dtype:
    `siso_windowed.launches` (float32) and `siso_windowed.launches_bf16`.
    """
    _check(sys_apr, par, beta_init, L, T, perm)
    if sys_apr.device.type == "cpu":
        return siso_windowed_plain(sys_apr, par, beta_init, L, T, emit_ext, perm)
    if sys_apr.device.type != "cuda":
        raise RuntimeError(f"no SISO kernel for device {sys_apr.device}")
    bf16 = sys_apr.dtype == torch.bfloat16
    plan = siso_plan(*sys_apr.shape, L, T, bf16)
    out = _launch(_lib("siso_windowed_bf16_launch" if bf16 else "siso_windowed_launch"),
                  sys_apr, par, beta_init, L, T, emit_ext, perm, plan.blocks, plan.smem_bytes)
    if bf16:
        siso_windowed.launches_bf16 += 1
    else:
        siso_windowed.launches += 1
    name = "siso_windowed_bf16" if bf16 else "siso_windowed"
    siso_windowed.shapes[(name, f"B={sys_apr.shape[0]} K={sys_apr.shape[1]} L={L} T={T}")] += 1
    return out


def _launch(fn, sys_apr, par, beta_init, L, T, emit_ext, perm, blocks, smem):
    """One launch of the kernel entry `fn` on checked CUDA tensors."""
    B, K = sys_apr.shape
    out = torch.empty_like(sys_apr)
    with torch.cuda.device(sys_apr.device):
        err = fn(sys_apr.data_ptr(), par.data_ptr(), beta_init.data_ptr(),
                 perm.data_ptr() if perm is not None else None, out.data_ptr(),
                 B, K, L, T, blocks, smem, int(emit_ext), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"siso_windowed kernel launch failed: CUDA error {err}")
    return out


def blocks_per_sm(plan: SisoPlan, emit_ext: bool = True, perm: bool = False,
                  lib: ctypes.CDLL | None = None) -> int:
    """Resident blocks per SM of the kernel (of `lib`, by default the built
    source) under `plan`, as the CUDA runtime computes it on the current
    device (a measurement aid; launches nothing)."""
    fn = (lib or _build.load("tdec_siso")).siso_windowed_blocks_per_sm
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    result = ctypes.c_int(0)
    err = fn(int(plan.windows_per_group == 2), int(emit_ext), int(perm), plan.smem_bytes,
             ctypes.byref(result))
    if err != 0:
        raise RuntimeError(f"occupancy query failed: CUDA error {err}")
    return result.value


# kernel launches made by this process, float32 and 16-bit (a CUDA graph's
# replay adds the launches it captured)
siso_windowed.launches = 0
siso_windowed.launches_bf16 = 0
siso_windowed.shapes = collections.Counter()  # by (kernel, shape)
jit.count_launches(siso_windowed, "launches", "launches_bf16", "shapes")
