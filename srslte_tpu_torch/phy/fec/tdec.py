"""Turbo decoder: iterative max-log-MAP (36.212 §5.1.3.2).

Reference behavior: lib/src/phy/fec/turbo/{turbodecoder.c, turbodecoder_sse.c}
(windowed max-log-MAP).  The whole code block *batch* is decoded together:
throughput comes from decoding many code blocks per dispatch, matching how
the C library batches CBs per transport block (sch.c:391-446).  Code blocks
of K >= 256 are decoded in windows by the CUDA kernel behind
`ops.tdec_cuda.siso_windowed`; shorter ones in one full-length pass
(`_siso_full`): on the card the same kernel as ONE window of L = K with no
training halo, on the CPU the plain scan `_siso`.

LLR convention: positive => bit 1 (matches demod_soft.c, scrambling flips).
Trellis tables from turbo.trellis_tables(); tail handling terminates each
constituent trellis through the 3 tail steps using the received tail LLRs.

Inputs use the dcat layout produced by turbo.rm_rx: [d0 | d1 | d2], each
stream K+4 long (data + re-arranged tails, 36.212 §5.1.3.2.2).

The windowed decoder runs its SISO metrics in float32 (the default) or in
bfloat16 (``siso_dtype=torch.bfloat16``, the numerics the JAX package runs on
its accelerator): inputs scaled to mean |sys| 8 and clipped at +-32, metrics
re-pinned to state 0 every step.  The short-block scans are float32 always.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..._device import as_tensor, table
from ...ops.tdec_cuda import NEG, siso_windowed, siso_windowed_plain
from .turbo import qpp_perm, qpp_perm_inv, trellis_tables


@functools.lru_cache(maxsize=1)
def _pred_tables():
    """Predecessor tables: for each state s', its 2 (prev_state, input, parity)."""
    nxt, par, *_ = trellis_tables()
    pred_s = np.zeros((8, 2), np.int32)
    pred_u = np.zeros((8, 2), np.int32)
    pred_p = np.zeros((8, 2), np.int32)
    cnt = [0] * 8
    for u in range(2):
        for s in range(8):
            sp = nxt[u, s]
            pred_s[sp, cnt[sp]] = s
            pred_u[sp, cnt[sp]] = u
            pred_p[sp, cnt[sp]] = par[u, s]
            cnt[sp] += 1
    assert all(c == 2 for c in cnt)
    return pred_s, pred_u, pred_p


def _tail_beta(tail_x, tail_z):
    """beta_K[s] from the 3 termination steps.

    tail_x/tail_z: [..., 3] LLRs of the tail systematic/parity bits.
    From state s the tail emits x(s)=s1^s2, z(s)=s0^s2 and shifts in a zero.
    """
    dev = tail_x.device
    _, _, tx, tz, tnext = trellis_tables()
    txj = table("tail_x", dev, lambda: tx.astype(np.float32))
    tzj = table("tail_z", dev, lambda: tz.astype(np.float32))
    tnj = table("tail_next", dev, lambda: tnext.astype(np.int64))
    # beta after all tails: 0 for state 0 else -inf
    beta = torch.full(tail_x.shape[:-1] + (8,), NEG, dtype=torch.float32, device=dev)
    beta[..., 0] = 0.0
    for i in (2, 1, 0):
        metric = txj * tail_x[..., i : i + 1] + tzj * tail_z[..., i : i + 1]
        beta = beta[..., tnj] + metric
        beta = beta - beta.max(dim=-1, keepdim=True).values
    return beta


def _siso(sys_apr, par, tail_x, tail_z):
    """One full-length max-log-MAP pass (code blocks too short for windows).

    sys_apr: [B, K] systematic+apriori LLR; par: [B, K] parity LLR;
    tail_x/tail_z: [B, 3].  Returns full LLR [B, K].
    Branch metric for (u, s): u*sys_apr + p(u,s)*par (max-log, scale-free).
    """
    dev = sys_apr.device
    nxt, parity, *_ = trellis_tables()
    pred_s, pred_u, pred_p = _pred_tables()
    nxt_j = table("siso_nxt", dev, lambda: nxt.astype(np.int64))  # [2, 8]
    par_j = table("siso_par", dev, lambda: parity.astype(np.float32))  # [2, 8]
    ps = table("siso_ps", dev, lambda: pred_s.astype(np.int64))
    pu = table("siso_pu", dev, lambda: pred_u.astype(np.float32))
    pp = table("siso_pp", dev, lambda: pred_p.astype(np.float32))
    B, K = sys_apr.shape

    a = torch.full((B, 8), NEG, dtype=torch.float32, device=dev)
    a[:, 0] = 0.0
    alphas = torch.empty((K, B, 8), dtype=torch.float32, device=dev)
    for k in range(K):
        alphas[k] = a  # alpha BEFORE this step
        sa, pr = sys_apr[:, k], par[:, k]
        # candidates for each new state: a[pred] + u*sa + p*par
        cand = a[:, ps] + pu[None] * sa[:, None, None] + pp[None] * pr[:, None, None]
        new = cand.max(dim=-1).values
        a = new - new.max(dim=-1, keepdim=True).values

    b = _tail_beta(tail_x, tail_z)  # [B, 8]
    u01 = torch.arange(2, dtype=torch.float32, device=dev)[None, :, None]
    llr = torch.empty((B, K), dtype=torch.float32, device=dev)
    for k in range(K - 1, -1, -1):
        sa, pr = sys_apr[:, k], par[:, k]
        # gamma for (u, s): u*sa + parity[u,s]*pr  -> [B, 2, 8]
        g = u01 * sa[:, None, None] + par_j[None] * pr[:, None, None]
        # LLR_k: max over u=1 branches vs u=0 branches of alpha + gamma + beta[next]
        tot = alphas[k][:, None, :] + g + b[:, nxt_j]  # [B, 2, 8]
        m = tot.max(dim=-1).values  # [B, 2]
        llr[:, k] = m[:, 1] - m[:, 0]
        # beta_k[s] = max_u beta_{k+1}[nxt[u,s]] + gamma(u,s)
        nb = (b[:, nxt_j] + g).max(dim=1).values
        b = nb - nb.max(dim=-1, keepdim=True).values
    return llr


def _siso_full(sys_apr, par, tail_x, tail_z):
    """One full-length max-log-MAP pass: LLRs [B, K] (K < 256).

    A CUDA tensor goes to the SISO kernel as one window over the whole code
    block (L = K, T = 0): window 0 is also the last, so alpha starts in state
    0 and beta from the tail, which is what `_siso` computes.  The metrics
    are float32 and not renormalised (K < 256 steps stay far inside its
    range), so the LLRs equal `_siso`'s up to float32 rounding.  A CPU
    tensor goes to `_siso`.
    """
    if sys_apr.device.type == "cpu":
        return _siso(sys_apr, par, tail_x, tail_z)
    K = sys_apr.shape[-1]
    return siso_windowed(sys_apr.contiguous(), par.contiguous(), _tail_beta(tail_x, tail_z),
                         L=K, T=0)


def _siso_windowed(sys_apr, par, tail_x, tail_z, L: int, T: int):
    """Windowed max-log-MAP in plain PyTorch ops: LLRs [B, K].

    Equivalent role to the C library's windowed SSE decoder
    (turbodecoder_sse.c): sequential depth drops from K to L+T, the batch
    grows by the number of windows.  This is the plain version the CUDA
    kernel is held against; the decoders below go through
    `ops.tdec_cuda.siso_windowed`, which launches the kernel on a CUDA tensor.
    """
    return siso_windowed_plain(sys_apr.contiguous(), par.contiguous(),
                               _tail_beta(tail_x, tail_z), L, T)


def default_window(k: int) -> int | None:
    """Window length (K need not divide it: the tail is masked); None = full scan.

    Larger windows amortize the 2T-step training halo over more useful
    positions (work scales with 1 + 2T/L), at the price of longer metric
    histories per window; 256 is never worse for BLER than 128."""
    if k >= 2048:
        return 256
    return 128 if k >= 256 else None


# ---------------------------------------------------------------------------
# Resumable decoder state
#
# The turbo cascade in dlsch.py runs phases (1 iter -> CRC -> +1 iter -> CRC
# -> compacted rest).  The split LLR streams, the tail-beta inits and the
# inter-SISO extrinsics are threaded through the phases as one state, so no
# phase repeats an earlier one's work.  Mirrors how the C library keeps one
# srsran_tdec_t state across run_all calls (turbodecoder.c:510 new_cb / :536
# run_all).
# ---------------------------------------------------------------------------


class TurboState(NamedTuple):
    """Resumable turbo decoder state (contiguous tensors).

    The SISO inputs and extrinsics are in the working dtype (float32 or
    bfloat16), scaled by `sc`; on the float32 path sc is 1 and `sys_sat`
    and `sys_d` are `sys` itself.
    """

    sys: torch.Tensor  # [B, K] float32 systematic LLR, unscaled
    sys_sat: torch.Tensor  # [B, K] scaled, clipped: decoder 1's systematic input
    sys_d: torch.Tensor  # [B, K] scaled, unclipped: decoder 2's systematic base
    par1: torch.Tensor  # [B, K] parity LLR of decoder 1 (scaled, clipped)
    par2: torch.Tensor  # [B, K] parity LLR of decoder 2 (interleaved domain)
    b01: torch.Tensor  # [B, 8] tail-beta init of decoder 1
    b02: torch.Tensor  # [B, 8] tail-beta init of decoder 2
    e1: torch.Tensor  # [B, K] decoder-1 extrinsic (natural order)
    ext2: torch.Tensor  # [B, K] decoder-2 extrinsic (interleaved domain)
    sc: torch.Tensor  # [] float32 fixed-point scale (1 on the float32 path)


_BF16_TARGET = 8.0  # mean |sys| after scaling
_BF16_CLIP = 32.0  # decoder-input saturation


def state_supported(k: int, window: int | None = 0) -> bool:
    """True when the windowed, resumable state path applies for this K."""
    if window == 0:
        window = default_window(k) if k >= 256 else None
    return bool(window)


def _split_dcat(dcat_llr, k: int):
    d = k + 4
    d0, d1, d2 = dcat_llr[..., :d], dcat_llr[..., d : 2 * d], dcat_llr[..., 2 * d :]
    sys, par1, par2 = d0[..., :k], d1[..., :k], d2[..., :k]
    # tail re-arrangement (36.212 §5.1.3.2.2): see turbo.turbo_encode_np
    t1x = torch.stack([d0[..., k], d2[..., k], d1[..., k + 1]], dim=-1)
    t1z = torch.stack([d1[..., k], d0[..., k + 1], d2[..., k + 1]], dim=-1)
    t2x = torch.stack([d0[..., k + 2], d2[..., k + 2], d1[..., k + 3]], dim=-1)
    t2z = torch.stack([d1[..., k + 2], d0[..., k + 3], d2[..., k + 3]], dim=-1)
    return sys, par1, par2, (t1x, t1z), (t2x, t2z)


def _perms(k: int, device):
    """(pi, pi_inv) as int64 for indexing and pi as int32 for the kernel."""
    pi = table(("qpp", k), device, lambda: qpp_perm(k).astype(np.int64))
    pi_inv = table(("qpp_inv", k), device, lambda: qpp_perm_inv(k).astype(np.int64))
    pi32 = table(("qpp32", k), device, lambda: qpp_perm(k).astype(np.int32))
    return pi, pi_inv, pi32


def _sat(x):
    """Clip at +-_BF16_CLIP on the 16-bit path; identity in float32."""
    if x.dtype == torch.bfloat16:
        return torch.clamp(x, -_BF16_CLIP, _BF16_CLIP)
    return x


def turbo_start(dcat_llr, k: int, L: int = 0, T: int = 32, device=None,
                siso_dtype: torch.dtype = torch.float32) -> TurboState:
    """Prepare a resumable decoder state from dcat LLRs [B, 3*(K+4)].

    siso_dtype float32 or bfloat16.  With bfloat16 the batch is scaled by sc
    = 8 / mean|sys| over the WHOLE batch [B, K] (so one code block's result
    depends on its batch, as in the JAX package); see `prepare_state`.  L
    and T are taken for the JAX package's signature; the state holds no
    window tensors, so they change nothing here."""
    dcat_llr = as_tensor(dcat_llr, device, torch.float32)
    sys, par1, par2, t1, t2 = _split_dcat(dcat_llr, k)
    if siso_dtype == torch.bfloat16:
        sc = _BF16_TARGET / (torch.mean(torch.abs(sys)) + 1e-20)
    else:
        sc = torch.ones((), dtype=torch.float32, device=sys.device)
    return prepare_state(sys, par1, par2, (t1, t2), sc, siso_dtype)


def prepare_state(sys, par1, par2, tails, sc, siso_dtype: torch.dtype,
                  sys_d=None) -> TurboState:
    """A fresh state from the split float32 LLRs [B, K], the tails
    ((t1x, t1z), (t2x, t2z)) [B, 3] and the scale sc (a float32 scalar).

    float32: sc is 1 and nothing is scaled.  bfloat16: the scaled
    systematic sys*sc is cast unclipped (`sys_d`, unless given) and, clipped
    at +-32, is decoder 1's input; both parities are scaled, cast and
    clipped (the reference clips in float32 before the cast: the same
    values, since +-32 is a bfloat16 and rounding is monotonic), and the
    tail-beta inits are computed in float32 from the scaled, unclipped
    tails, then cast."""
    (t1x, t1z), (t2x, t2z) = tails
    sys = sys.contiguous()
    sc = torch.as_tensor(sc, dtype=torch.float32, device=sys.device)
    if siso_dtype == torch.float32:
        return TurboState(
            sys=sys, sys_sat=sys, sys_d=sys, par1=par1.contiguous(),
            par2=par2.contiguous(), b01=_tail_beta(t1x, t1z), b02=_tail_beta(t2x, t2z),
            e1=torch.zeros_like(sys), ext2=torch.zeros_like(sys), sc=sc)
    if siso_dtype != torch.bfloat16:
        raise ValueError(f"siso_dtype must be float32 or bfloat16, got {siso_dtype}")
    bf16 = torch.bfloat16
    if sys_d is None:
        sys_d = (sys * sc).to(bf16)
    sys_d = sys_d.to(bf16).contiguous()
    return TurboState(
        sys=sys, sys_sat=_sat(sys_d), sys_d=sys_d,
        par1=_sat((par1 * sc).to(bf16)).contiguous(), par2=_sat((par2 * sc).to(bf16)).contiguous(),
        b01=_tail_beta(t1x * sc, t1z * sc).to(bf16),
        b02=_tail_beta(t2x * sc, t2z * sc).to(bf16),
        e1=torch.zeros_like(sys, dtype=bf16), ext2=torch.zeros_like(sys, dtype=bf16),
        sc=sc)


def turbo_step(st: TurboState, k: int, n_iter: int, L: int = 0, T: int = 32,
               first: bool = False) -> TurboState:
    """Run n_iter turbo iterations on a prepared state (resumable).

    first=True skips the decoder-2-extrinsic gather of the very first
    sub-iteration (ext2 is identically zero in a fresh state).  Both SISOs
    emit extrinsics, and the QPP interleave ahead of the second one is folded
    into the kernel's input read.  The working dtype is the state's; on the
    16-bit path the two SISO inputs are bfloat16 adds followed by the clip,
    decoder 2's taken in natural order and then permuted.
    """
    if L == 0:
        L = default_window(k) or 128
    pi, pi_inv, pi32 = _perms(k, st.sys.device)
    e1, ext2 = st.e1, st.ext2
    for it in range(n_iter):
        sa1 = st.sys_sat if (first and it == 0) else _sat(st.sys_sat + ext2[:, pi_inv])
        e1 = siso_windowed(sa1, st.par1, st.b01, L, T, emit_ext=True)
        ext2 = siso_windowed(_sat(st.sys_d + e1), st.par2, st.b02, L, T, emit_ext=True,
                             perm=pi32)
    return st._replace(e1=e1, ext2=ext2)


def turbo_hard(st: TurboState, k: int):
    """Posterior from state -> (hard bits [B, K] uint8, post f32, apr1 f32).

    The extrinsics are taken to float32 and unscaled by sc there."""
    _, pi_inv, _ = _perms(k, st.sys.device)
    apr1 = st.ext2[..., pi_inv].to(torch.float32) / st.sc
    post = st.sys + st.e1.to(torch.float32) / st.sc + apr1
    return (post > 0).to(torch.uint8), post, apr1


def turbo_take(st: TurboState, idx, k: int, L: int = 0,
               T: int = 32) -> TurboState:
    """Compact the state to the code-block subset idx (L and T as in
    `turbo_start`); the scale sc is kept."""
    return TurboState(*(t if t.dim() == 0 else t[idx].contiguous() for t in st))


def turbo_decode(dcat_llr, k: int, n_iter: int = 5, window: int | None = 0,
                 apr0=None, return_state: bool = False, device=None,
                 siso_dtype: torch.dtype = torch.float32):
    """Decode a batch: dcat_llr [B, 3*(K+4)] -> (hard bits [B, K] uint8, llr [B, K]).

    dcat layout per turbo.turbo_encode_np.
    window: max-log-MAP window length (K need not divide it); 0 = auto
    (windowed for K >= 256, sequential depth L+32 instead of K); None =
    full-length passes (`_siso_full`).
    apr0: optional decoder-1 a-priori state [B, K] from a previous call, a
    WARM START: `turbo_decode(x, k, m, apr0=s)` after `..., n, return_state
    =True` equals a single (n+m)-iteration decode (the C library's
    early-stopping decoder keeps iterating the same state, tdec run_all).
    return_state: also return the apr state for later resumption.
    siso_dtype: the windowed path's working dtype (`turbo_start`); the
    full-length passes are float32 always.
    """
    dcat_llr = as_tensor(dcat_llr, device, torch.float32)
    if window == 0:
        window = default_window(k) if k >= 256 else None
    pi, pi_inv, _ = _perms(k, dcat_llr.device)
    if apr0 is not None:
        apr0 = as_tensor(apr0, dcat_llr.device, torch.float32)

    if window:
        st = turbo_start(dcat_llr, k, L=window, T=32, siso_dtype=siso_dtype)
        if apr0 is not None:
            st = st._replace(ext2=(apr0 * st.sc)[..., pi].to(st.e1.dtype).contiguous())
        st = turbo_step(st, k, n_iter, L=window, T=32, first=apr0 is None)
        hard, post, apr1 = turbo_hard(st, k)
    else:
        sys, par1, par2, (t1x, t1z), (t2x, t2z) = _split_dcat(dcat_llr, k)
        apr1 = torch.zeros_like(sys) if apr0 is None else apr0
        post = sys
        for _ in range(n_iter):
            llr1 = _siso_full(sys + apr1, par1, t1x, t1z)
            ext1 = llr1 - sys - apr1
            in2 = (sys + ext1)[..., pi]
            llr2 = _siso_full(in2, par2, t2x, t2z)
            ext2 = llr2 - in2
            apr1 = ext2[..., pi_inv]
            # llr2 deinterleaved = sys + ext1 + ext2: the full posterior
            post = llr2[..., pi_inv]
        hard = (post > 0).to(torch.uint8)
    if return_state:
        return hard, post, apr1
    return hard, post
