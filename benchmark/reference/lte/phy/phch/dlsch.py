# Frozen copy of srslte_tpu_torch/phy/phch/dlsch.py at commit e4337f4, unchanged but for this line.
"""DL-SCH transport channel coding (36.212 §5.3.2, sch.c equivalent).

Reference behavior: lib/src/phy/phch/sch.c (srsran_dlsch_encode / decode_tb:
TB CRC24A -> segmentation (+CRC24B per CB) -> per-CB turbo + rate matching ->
concatenation; decode reverses with soft combining and CRC gates).

Every stage is static-shape per (tbs, G, Qm) bucket.  Code blocks of equal K
are decoded as one batch through the windowed max-log-MAP decoder; CRCs are
GF(2) matrix products (fec.crc.crc_ok_device).  The decoder's early
termination is a cascade of phases whose branches are `utils.jit.cond` on
CRC counts, as the reference's are `lax.cond`: one CUDA graph on the card,
whatever the branches taken.

Every redundancy version decodes through the same path: the de-rate-matching
tables of a bucket are built for its `rv`.  Combining several transmissions
into one soft buffer is `mac.harq`.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from ..._device import as_tensor, table
from ...utils import jit
from ..fec import crc as crcmod
from ..fec import tdec, turbo
from ..fec.cbsegm import CbSegm, cbsegm
from ..fec.tdec import turbo_decode


@dataclass(frozen=True)
class CbGroup:
    """A run of code blocks sharing static shapes."""

    first_r: int  # index of first CB in TB order
    count: int
    K: int
    E: int
    F: int  # filler bits (only ever non-zero for the group containing CB 0)
    data_bits: int  # payload bits carried per CB (K - F - cb_crc)


@dataclass(frozen=True)
class DlschConfig:
    """Static shapes for one transport block bucket."""

    tbs: int
    G: int  # total coded bits available (n_re * Qm * n_layers)
    Qm: int
    n_layers: int = 1
    rv: int = 0

    @functools.cached_property
    def seg(self) -> CbSegm:
        return cbsegm(self.tbs)

    @functools.cached_property
    def groups(self) -> tuple[CbGroup, ...]:
        seg = self.seg
        c = seg.C
        cb_crc = 24 if c > 1 else 0
        # 36.212 §5.1.4.1.2 bit selection: E per CB
        gp = self.G // (self.n_layers * self.Qm)
        gamma = gp % c
        e_lo = self.n_layers * self.Qm * (gp // c)
        e_hi = self.n_layers * self.Qm * (-(-gp // c))
        ks = [seg.K2] * seg.C2 + [seg.K1] * seg.C1  # K- blocks first (36.212)
        es = [e_lo if r <= c - gamma - 1 else e_hi for r in range(c)]
        fs = [seg.F if r == 0 else 0 for r in range(c)]
        groups: list[CbGroup] = []
        r = 0
        while r < c:
            r2 = r
            while r2 + 1 < c and (ks[r2 + 1], es[r2 + 1], fs[r2 + 1]) == (ks[r], es[r], fs[r]):
                r2 += 1
            groups.append(CbGroup(first_r=r, count=r2 - r + 1, K=ks[r], E=es[r], F=fs[r],
                                  data_bits=ks[r] - fs[r] - cb_crc))
            r = r2 + 1
        assert sum(g.count * g.data_bits for g in groups) == self.tbs + 24
        return tuple(groups)


def dlsch_encode(bits, cfg: DlschConfig, device=None):
    """bits [..., tbs] {0,1} -> coded bits [..., G] uint8."""
    bits = as_tensor(bits, device)
    seg = cfg.seg
    # TB CRC24A
    poly, order = crcmod.LTE_CRC24A
    tb_crc = crcmod.crc_calc(bits, poly, order)
    b = torch.cat([bits.to(torch.float32), tb_crc], dim=-1)

    out = []
    pos = 0
    for g in cfg.groups:
        for i in range(g.count):
            chunk = b[..., pos : pos + g.data_bits]
            pos += g.data_bits
            cb = chunk
            if g.F:
                cb = torch.cat([chunk.new_zeros(chunk.shape[:-1] + (g.F,)), chunk], dim=-1)
            if seg.C > 1:
                pb, po = crcmod.LTE_CRC24B
                cb = torch.cat([cb, crcmod.crc_calc(cb, pb, po)], dim=-1)
            d = turbo.turbo_encode(cb, g.K)
            out.append(turbo.rm_tx(d, g.K, e=g.E, rv=cfg.rv, f=g.F))
    return torch.cat(out, dim=-1).to(torch.uint8)


@functools.lru_cache(maxsize=None)
def _derm_tables(cfg: DlschConfig):
    """Per distinct K: (K, f0, IDX [C, 3(K+4), rmax], MASK, FILL [C, 3(K+4)]).

    The per-CB inverse rate-matching maps (different E, offsets into the
    concatenated llr, fillers) folded into one constant index tensor."""
    clusters: dict[int, list] = {}
    pos = 0
    for g in cfg.groups:
        for i in range(g.count):
            f = g.F if (g.first_r == 0 and i == 0) else 0
            clusters.setdefault(g.K, []).append((pos, g.E, f))
            pos += g.E
    out = []
    for K, cbs in clusters.items():
        J = 3 * (K + 4)
        invs = []
        for (off, E, f) in cbs:
            inv, r = turbo._rm_rx_inverse(K, E, cfg.rv, f, None)
            invs.append((off, inv, f))
        rmax = max(i.shape[1] for _, i, _ in invs)
        IDX = np.zeros((len(cbs), J, rmax), np.int64)
        MASK = np.zeros((len(cbs), J, rmax), np.float32)
        FILL = np.zeros((len(cbs), J), np.float32)
        for c, (off, inv, f) in enumerate(invs):
            r = inv.shape[1]
            IDX[c, :, :r] = off + np.maximum(inv, 0)
            MASK[c, :, :r] = inv >= 0
            if f > 0:
                FILL[c, :f] = -1e4  # d0 fillers are known zeros
        out.append((K, cbs[0][2], IDX, MASK, FILL))
    return tuple(out)


def _derm_clusters(llr, cfg: DlschConfig):
    """De-rate-match ALL code blocks sharing a K in one gather.

    Returns [(K, f0, w [..., C, 3*(K+4)])] in transport-block order: a whole
    TB needs one gather + one turbo batch per distinct K (36.212 orders K-
    blocks before K+, so cluster concatenation preserves TB order).  The index
    tensors are built once per bucket and kept on the device.
    """
    out = []
    for K, f0, IDX, MASK, FILL in _derm_tables(cfg):
        idx = table(("derm_idx", cfg, K), llr.device, lambda: IDX)
        mask = table(("derm_mask", cfg, K), llr.device, lambda: MASK)
        fill = table(("derm_fill", cfg, K), llr.device, lambda: FILL)
        w = torch.sum(llr[..., idx] * mask, dim=-1)
        out.append((K, f0, w + fill))
    return out


@jit.stage(static_argnames=("cfg", "n_iter", "early", "compact_frac", "device", "siso_dtype"))
def dlsch_decode(llr, cfg: DlschConfig, n_iter: int = 5, early: int = 1,
                 compact_frac: int = 8, device=None,
                 siso_dtype: torch.dtype = torch.float32):
    """llr [..., G] (positive => bit 1) -> (bits [..., tbs] uint8, crc_ok [...]).

    Early termination over a batch: the C library's turbo decoder stops
    iterating per CB when the CRC passes (effectively 1-2 iterations at
    operating SNR).  Here:

      phase 1: decode ALL code blocks at `early` iterations; CB-level CRC.
      phase 2: one more iteration on everything (the same decoder state).
      phase 3: gather the failing CBs into a dense batch of capacity
        ceil(N/compact_frac) and iterate those, with a second compaction at a
        quarter of that capacity for the stragglers.  Only when the failure
        count exceeds a capacity (wrong operating point) is the whole batch
        iterated further.

    On a clean channel this costs `early` iterations; at an operating point
    with a few percent early-phase failures it costs early + 1 +
    n_iter/compact_frac instead of n_iter.  Every branch gives the result of
    the same decoder; the branches differ only in which blocks they spend
    iterations on.  They are the reference's five `jit.cond` per cluster of
    code blocks, on counts the device computes: on the card one graph
    holds them all, and a replay runs the branches the counts pick.

    siso_dtype: the windowed turbo decoder's working dtype, float32 or
    bfloat16 (`tdec.turbo_start`); all same-K code blocks of the batch share
    one bfloat16 scale.
    """
    llr = as_tensor(llr, device, torch.float32)
    if not (early and early < n_iter):
        return _dlsch_decode_fixed(llr, cfg, n_iter, siso_dtype)
    hards = tuple(_cascade(w.reshape((-1, w.shape[-1])), cfg, j, n_iter, early, compact_frac,
                           siso_dtype)
                  for j, (_, _, w) in enumerate(_derm_clusters(llr, cfg)))
    return _tail(hards, cfg, tuple(llr.shape[:-1]))


def _cascade(flat, cfg: DlschConfig, j: int, n_iter: int, early: int, compact_frac: int,
             siso_dtype):
    """The cascade of cluster j, all its code blocks [Ng, 3(K+4)] as one
    batch -> hard decisions [Ng, K]."""
    K, _ = _cluster(cfg, j)
    mid = min(n_iter, early + 1)
    cap = _cap(flat.shape[0], compact_frac)
    cap2 = max(1, cap // 4)
    # phase 1: `early` iterations on everything (clean channels exit here)
    hard1, st1 = _dec_init(flat, K, early, siso_dtype)

    def phases23():
        # phase 2: resume the SAME decoder state for mid - early more
        # iterations (a warm start: equals a `mid`-iteration decode)
        hard2, st2 = _dec_more(st1, K, mid - early)
        if mid >= n_iter:
            return hard2
        ok2 = _cb_ok(hard2, cfg, j)
        idx = _worst(ok2, cap)
        nfail = (~ok2).sum()

        def compact():
            # phase 3: survivors only, resumed, one iteration; then a
            # second, 4x deeper compaction for the stragglers
            hard3, st3 = _dec_more(_dec_take(st2, idx, K), K, 1)
            if n_iter - mid > 1:
                ok3 = _cb_ok(hard3, cfg, j)
                idx3 = _worst(ok3, cap2)
                nfail3 = (~ok3).sum()

                def deeper():
                    hard4 = _dec_more(_dec_take(st3, idx3, K), K, n_iter - mid - 1)[0]
                    return _merge(hard3, ok3, idx3, hard4)

                def full3():
                    return _dec_more(st3, K, n_iter - mid - 1)[0]

                hard3 = jit.cond(nfail3 == 0, lambda h=hard3: h,
                                 lambda: jit.cond(nfail3 <= cap2, deeper, full3))
            return _merge(hard2, ok2, idx, hard3)

        def full():
            return _dec_more(st2, K, n_iter - mid)[0]

        return jit.cond(nfail == 0, lambda: hard2,
                        lambda: jit.cond(nfail <= cap, compact, full))

    return jit.cond(_cb_ok(hard1, cfg, j).all(), lambda: hard1, phases23)


def _cluster(cfg: DlschConfig, j: int):
    K, f0, *_ = _derm_tables(cfg)[j]
    return K, f0


def _cb_ok(hard, cfg: DlschConfig, j: int):
    """The CRC of each code block [Ng, K] of cluster j."""
    K, f0 = _cluster(cfg, j)
    if cfg.seg.C > 1:
        return crcmod.crc_ok_device(hard, *crcmod.LTE_CRC24B)
    return crcmod.crc_ok_device(hard[..., f0:], *crcmod.LTE_CRC24A)


def _cap(ng: int, compact_frac: int) -> int:
    return max(1, -(-ng // compact_frac))


# Decoder adapter: windowed code blocks thread a resumable TurboState through
# the phases; short ones thread the decoder-1 a-priori.

def _dec_init(flat, K: int, n: int, siso_dtype):
    if tdec.state_supported(K):
        st = tdec.turbo_step(tdec.turbo_start(flat, K, siso_dtype=siso_dtype), K, n,
                             first=True)
        return tdec.turbo_hard(st, K)[0], st
    hard, _, apr = turbo_decode(flat, K, n_iter=n, return_state=True)
    return hard, (flat, apr)


def _dec_more(st, K: int, n: int):
    if tdec.state_supported(K):
        st = tdec.turbo_step(st, K, n)
        return tdec.turbo_hard(st, K)[0], st
    f, a = st
    hard, _, apr = turbo_decode(f, K, n_iter=n, apr0=a, return_state=True)
    return hard, (f, apr)


def _dec_take(st, idx, K: int):
    if tdec.state_supported(K):
        return tdec.turbo_take(st, idx, K)
    return (st[0][idx], st[1][idx])


def _worst(ok, n: int):
    """Indices of the n blocks to iterate further: failures first."""
    return torch.argsort(ok.to(torch.int32), stable=True)[:n]


def _merge(hard, ok, idx, hard_sub):
    """hard with rows idx replaced by hard_sub where ok is False."""
    out = hard.clone()
    out[idx] = torch.where(ok[idx][:, None], hard[idx], hard_sub)
    return out


def _tail(hards, cfg, batch):
    """Per-CB payload extraction, the CB and TB CRCs -> (bits, crc_ok).

    Only the first CB of the TB carries filler bits (f0 applies to
    cluster-local CB 0 iff it is TB CB 0)."""
    seg = cfg.seg
    cb_crc = 24 if seg.C > 1 else 0
    parts, ok_parts = [], []
    for (K, f0, IDX, *_), hard in zip(_derm_tables(cfg), hards):
        count = IDX.shape[0]
        hard = hard.reshape(batch + (count, K))
        if seg.C > 1:
            ok_parts.append(crcmod.crc_ok_device(hard, *crcmod.LTE_CRC24B))
        for c in range(count):
            parts.append(hard[..., c, (f0 if c == 0 else 0) : K - cb_crc])
    b = torch.cat(parts, dim=-1)  # [..., tbs+24]
    tb_ok = crcmod.crc_ok_device(b, *crcmod.LTE_CRC24A)
    if ok_parts:
        tb_ok = tb_ok & torch.all(torch.cat(ok_parts, dim=-1), dim=-1)
    return b[..., : cfg.tbs].to(torch.uint8), tb_ok


def _dlsch_decode_fixed(llr, cfg: DlschConfig, n_iter: int, siso_dtype=torch.float32):
    """Fixed-iteration decode of the whole batch."""
    seg = cfg.seg
    batch = llr.shape[:-1]
    parts, ok_parts = [], []
    pos = 0
    for g in cfg.groups:
        block = llr[..., pos : pos + g.count * g.E]
        pos += g.count * g.E
        e = block.reshape(batch + (g.count, g.E))
        w = turbo.rm_rx(e, g.K, rv=cfg.rv, f=g.F)
        flat = w.reshape((-1, w.shape[-1]))
        hard, _ = turbo_decode(flat, g.K, n_iter=n_iter, siso_dtype=siso_dtype)
        hard = hard.reshape(batch + (g.count, g.K))
        if seg.C > 1:
            pb, po = crcmod.LTE_CRC24B
            ok_parts.append(crcmod.crc_ok_device(hard, pb, po))  # [..., count]
            payload = hard[..., g.F : g.K - 24]
        else:
            payload = hard[..., g.F :]
        parts.append(payload.reshape(batch + (g.count * g.data_bits,)))
    b = torch.cat(parts, dim=-1)  # [..., tbs+24]
    pa, oa = crcmod.LTE_CRC24A
    tb_ok = crcmod.crc_ok_device(b, pa, oa)
    if ok_parts:
        tb_ok = tb_ok & torch.all(torch.cat(ok_parts, dim=-1), dim=-1)
    return b[..., : cfg.tbs].to(torch.uint8), tb_ok
