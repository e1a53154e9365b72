"""Plain stand-in for the port's `ops/tdec_cuda.py` at commit e4337f4: its
plain PyTorch SISO (`siso_windowed_plain`, copied unchanged with its tables and checks)
on every device, in place of the CUDA kernel.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

NEG = -1e9


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


def siso_windowed(sys_apr, par, beta_init, L: int, T: int,
                  emit_ext: bool = False, perm=None):
    """The port's `siso_windowed`, on any device, by its plain version."""
    _check(sys_apr, par, beta_init, L, T, perm)
    return siso_windowed_plain(sys_apr, par, beta_init, L, T, emit_ext, perm)
