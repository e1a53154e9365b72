# Frozen copy of srslte_tpu_torch/phy/mimo/mimo.py at commit e4337f4, unchanged but for this line.
"""Layer mapping, transmit diversity, spatial multiplexing and equalization
(36.211 §6.3.3-4).

Reference behavior: lib/src/phy/mimo/{layermap.c, precoding.c}: single-port
(TM1) passthrough with ZF/MMSE equalization; 2-port SFBC transmit diversity
(TM2 / PBCH / PDCCH) per 36.211 §6.3.4.3:

    port0: [ x0,  x1 ]      port1: [ -x1*, x0* ]   (pairs of subcarriers,
    with 1/sqrt(2) scaling at the transmitter)

4-port SFBC-FSTD; 2-layer spatial multiplexing (TM3 large-delay CDD, TM4
codebook) with a closed-form per-RE 2x2 MMSE; and 4-port rank-1..4 spatial
multiplexing with a batched 4x4 solve per RE (beyond the C library's 2x2
ceiling).

Everything is elementwise over REs and batched over leading dims.  The
per-RE small matrix products are written as broadcast sums over the
contracted axis; the constant precoders are host tables uploaded once.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..._device import as_tensor, table


def layermap_single(symbols):
    return symbols


def layerdemap_single(symbols):
    return symbols


def equalize_zf(y, h):
    """Zero-forcing 1x1: x = y / h (precoding.c srsran_predecoding_single)."""
    return y * torch.conj(h) / torch.clamp(torch.abs(h) ** 2, min=1e-12)


def equalize_mmse(y, h, noise_var):
    """MMSE 1x1: x = conj(h) y / (|h|^2 + sigma^2).

    noise_var broadcasts against y's batch dims (precoding.c:841+ semantics;
    the output is the symbol estimate, for unit-energy constellations).
    """
    return y * torch.conj(h) / (torch.abs(h) ** 2 + noise_var)


def alamouti_encode_2tx(x):
    """SFBC: x [..., n] (n even) -> per-port symbols [..., 2, n].

    36.211 §6.3.4.3 with the C library's pairing over adjacent REs
    (precoding.c srsran_precoding_diversity, 2 ports).
    """
    x0, x1 = x[..., 0::2], x[..., 1::2]
    p0 = torch.stack([x0, x1], dim=-1).reshape(x.shape)
    p1 = torch.stack([-torch.conj(x1), torch.conj(x0)], dim=-1).reshape(x.shape)
    return torch.stack([p0, p1], dim=-2) / math.sqrt(2.0)


def alamouti_decode_2tx(y, h0, h1, noise_var=0.0):
    """SFBC combine: y [..., n], per-port channels h0/h1 [..., n] -> x [..., n].

    Alamouti combining over RE pairs (precoding.c
    srsran_predecoding_diversity), the channel of each pair member taken as
    its own estimate:
      y_a = (h0 x0 - h1 x1*)/sqrt2 ; y_b = (h0 x1 + h1 x0*)/sqrt2
      x0 = sqrt2 (h0a* y_a + h1b y_b*) / (|h0|^2+|h1|^2)
      x1 = sqrt2 (h0b* y_b - h1a y_a*) / (|h0|^2+|h1|^2)
    """
    ya, yb = y[..., 0::2], y[..., 1::2]
    h0a, h0b = h0[..., 0::2], h0[..., 1::2]
    h1a, h1b = h1[..., 0::2], h1[..., 1::2]
    denom = (torch.abs(h0a) ** 2 + torch.abs(h1a) ** 2) / 2 \
        + (torch.abs(h0b) ** 2 + torch.abs(h1b) ** 2) / 2 + noise_var
    denom = torch.clamp(denom, min=1e-12)
    x0 = (torch.conj(h0a) * ya + h1b * torch.conj(yb)) / denom
    x1 = (torch.conj(h0b) * yb - h1a * torch.conj(ya)) / denom
    out = torch.stack([x0, x1], dim=-1).reshape(y.shape)
    return out * math.sqrt(2.0)


def _const(key, arr, device):
    """A constant host table on the device (complex64)."""
    return table(("mimo", key), device, lambda: np.asarray(arr, np.complex64))


def _nv(noise_var, device):
    """The scalar regularizer: the mean of every noise value given (the
    reference's semantics: one value for the whole batch)."""
    return torch.mean(as_tensor(noise_var, device, torch.float32))


# ---------------------------------------------------------------- 2-layer SM
# 36.211 table 6.3.4.2.3-1: 2-port rank-2 codebook (precoding.c pmi tables)
_W2 = np.stack([
    np.array([[1, 0], [0, 1]], np.complex64) / np.sqrt(2),          # identity
    np.array([[1, 1], [1, -1]], np.complex64) / 2,                  # pmi 1
    np.array([[1, 1], [1j, -1j]], np.complex64) / 2,                # pmi 2
])
# large-delay CDD (TM3): D(i) = diag(1, e^{-j*pi*i}), U = DFT2
_U2 = np.array([[1, 1], [1, np.exp(-1j * np.pi)]], np.complex64) / np.sqrt(2)


@functools.lru_cache(maxsize=None)
def _cdd2_phase(n: int) -> np.ndarray:
    """e^{-j pi i}, i < n, as complex64: the float32 angle of the reference
    (up to 3.3e-3 off +-1 at 100 PRB), computed on the host so that every
    device sees the same values."""
    return torch.exp(-1j * torch.pi * torch.arange(n)).numpy()


@functools.lru_cache(maxsize=None)
def _cdd4_phase(n: int) -> np.ndarray:
    """D(i) of the 4-port CDD: e^{-j 2 pi i k / 4}, [4, n] complex64, in the
    reference's float32 order of operations."""
    i, k = torch.arange(n), torch.arange(4)
    return torch.exp(-2j * torch.pi * i[None, :] * k[:, None] / 4).numpy()


def precode_sm_2layer(x, pmi: int | None = None):
    """Spatial multiplexing, 2 layers -> 2 ports.

    x [..., 2, n]: layer symbols.  pmi None => TM3 large-delay CDD
    (precoding.c srsran_precoding_cdd); else TM4 codebook entry.
    Returns per-port symbols [..., 2, n].
    """
    x = x.to(torch.complex64)
    if pmi is None:
        n = x.shape[-1]
        d1 = table(("cdd2", n), x.device, lambda: _cdd2_phase(n))
        # s' = U x ; s'' = D s' ; y = W s'' with W = I/sqrt(2)
        sp = torch.matmul(_const("u2", _U2, x.device), x)
        sp = sp * torch.stack([torch.ones_like(d1), d1])
        return sp / math.sqrt(2.0)
    return torch.matmul(_const(("w2", pmi), _W2[pmi], x.device), x)


def mmse_sm_2layer(y, h, noise_var, pmi: int | None = None):
    """2x2 MMSE detection: y [..., 2rx, n], h [..., 2rx, 2tx, n] -> x [..., 2, n].

    The effective channel folds in the precoder (CDD for TM3 / codebook for
    TM4); per-RE 2x2 inversion in closed form (precoding.c srsran_predecoding
    _type MMSE path).  Also returns per-layer post-MMSE gain for LLR scaling.
    """
    h = h.to(torch.complex64)
    dev = h.device
    if pmi is None:
        n = y.shape[-1]
        d1 = table(("cdd2", n), dev, lambda: _cdd2_phase(n))
        u = _const("u2", _U2, dev)
        dmat = torch.stack([torch.ones_like(d1), d1])  # [2, n]
        # heff[r, l, n] = sum_k h[r,k,n] * (W D U)[k,l,n], W = I/sqrt2
        wdu = (dmat[:, None, :] * u[:, :, None]) / math.sqrt(2.0)  # [k, l, n]
        heff = h[..., :, 0, None, :] * wdu[0] + h[..., :, 1, None, :] * wdu[1]
    else:
        w = _const(("w2", pmi), _W2[pmi], dev)
        heff = h[..., :, 0, None, :] * w[0, :, None] + h[..., :, 1, None, :] * w[1, :, None]
    return mmse_2x2(y, heff, noise_var)


def mmse_2x2(y, heff, noise_var):
    """Closed-form per-RE 2x2 MMSE on an EFFECTIVE channel.

    y [..., 2rx, n], heff [..., 2rx, 2layer, n] -> (x [..., 2, n],
    per-layer gain [..., 2, n]).  The regularizer is the mean of every
    noise value given.
    """
    # A = H^H H + nv I  (2x2), x = A^-1 H^H y
    hh = torch.conj(heff.transpose(-3, -2))  # [..., l, r, n]
    a = (hh[..., :, :, None, :] * heff[..., None, :, :, :]).sum(-3)  # [..., l, m, n]
    nv = _nv(noise_var, heff.device)
    a00 = a[..., 0, 0, :] + nv
    a11 = a[..., 1, 1, :] + nv
    a01 = a[..., 0, 1, :]
    a10 = a[..., 1, 0, :]
    det = a00 * a11 - a01 * a10
    z = (hh * y.to(torch.complex64)[..., None, :, :]).sum(-2)  # [..., l, n]
    x0 = (a11 * z[..., 0, :] - a01 * z[..., 1, :]) / det
    x1 = (-a10 * z[..., 0, :] + a00 * z[..., 1, :]) / det
    # post-MMSE effective gain per layer (for LLR weighting)
    g0 = torch.real(a00 - nv)
    g1 = torch.real(a11 - nv)
    return torch.stack([x0, x1], dim=-2), torch.stack([g0, g1], dim=-2)


# ----------------------------------------------------------- 4-port SM (TM3/4)
# 36.211 table 6.3.4.2.3-2: Householder codebook W_n = I - 2 u_n u_n^H / |u_n|^2.
# The C library stops at 2x2 spatial multiplexing (precoding.c
# pmi_select_1l/2l and srsran_precoding_cdd reject 4 ports); this is the full
# 4-port rank-1..4 codebook for peak-rate operation.
_SQ2 = np.sqrt(0.5)
_U4 = np.array([
    [1, -1, -1, -1],
    [1, -1j, 1, 1j],
    [1, 1, -1, 1],
    [1, 1j, 1, -1j],
    [1, (-1 - 1j) * _SQ2, -1j, (1 - 1j) * _SQ2],
    [1, (1 - 1j) * _SQ2, 1j, (-1 - 1j) * _SQ2],
    [1, (1 + 1j) * _SQ2, -1j, (-1 + 1j) * _SQ2],
    [1, (-1 + 1j) * _SQ2, 1j, (1 + 1j) * _SQ2],
    [1, -1, 1, 1],
    [1, -1j, -1, -1j],
    [1, 1, 1, -1],
    [1, 1j, -1, 1j],
    [1, -1, -1, 1],
    [1, -1, 1, -1],
    [1, 1, -1, -1],
    [1, 1, 1, 1],
], np.complex64)

_W4 = np.stack([np.eye(4, dtype=np.complex64)
                - 2.0 * np.outer(u, u.conj()) / np.vdot(u, u).real
                for u in _U4])

# per-rank column selections (1-indexed in the spec; 0-indexed here)
_CB4_COLS = {
    1: [[0]] * 16,
    2: [[0, 3], [0, 1], [0, 1], [0, 1], [0, 3], [0, 3], [0, 2], [0, 2],
        [0, 1], [0, 3], [0, 2], [0, 2], [0, 1], [0, 2], [0, 2], [0, 1]],
    3: [[0, 1, 3], [0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1, 3], [0, 1, 3],
        [0, 2, 3], [0, 2, 3], [0, 1, 3], [0, 2, 3], [0, 1, 2], [0, 2, 3],
        [0, 1, 2], [0, 1, 2], [0, 1, 2], [0, 1, 2]],
    4: [[0, 1, 2, 3], [0, 1, 2, 3], [2, 1, 0, 3], [2, 1, 0, 3],
        [0, 1, 2, 3], [0, 1, 2, 3], [0, 2, 1, 3], [0, 2, 1, 3],
        [0, 1, 2, 3], [0, 1, 2, 3], [0, 2, 1, 3], [0, 2, 1, 3],
        [0, 1, 2, 3], [0, 2, 1, 3], [2, 1, 0, 3], [0, 1, 2, 3]],
}


def codebook_4port(pmi: int, n_layers: int) -> np.ndarray:
    """[4 ports, n_layers] precoder, power-normalized per 36.211."""
    w = _W4[pmi][:, _CB4_COLS[n_layers][pmi]]
    return (w / np.sqrt(n_layers)).astype(np.complex64)


# TM3 large-delay CDD, 4 ports (36.211 §6.3.4.2.2): U fixed 4x4 DFT,
# D(i) = diag(e^{-j2pi*i*k/4}), W(i) cycles over codebook indices 12..15.
_DFT4 = np.exp(-2j * np.pi * np.outer(np.arange(4), np.arange(4)) / 4) / 2.0
_CDD4_W = np.stack([_W4[k][:, _CB4_COLS[4][k]] for k in (12, 13, 14, 15)])


@functools.lru_cache(maxsize=None)
def _cdd4_matrix(n: int) -> np.ndarray:
    """M(i) = W(i) D(i) U / 2 for every RE i < n: [n, 4 ports, 4 layers]
    complex64 (the 4-port CDD precoder folded into one matrix per RE)."""
    d = torch.from_numpy(_cdd4_phase(n))
    wc = torch.from_numpy(_CDD4_W)[torch.arange(n) % 4]  # [n, 4, 4]
    u = torch.from_numpy(_DFT4.astype(np.complex64))
    du = d.T[:, :, None] * u[None, :, :]  # [n, k, l]
    return (torch.einsum("npk,nkl->npl", wc, du) / 2.0).numpy()


def precode_sm_4port(x, pmi: int | None = None):
    """4-port spatial multiplexing: x [..., nl, n] layers -> [..., 4, n].

    pmi None = TM3 large-delay CDD (4 layers); else TM4 codebook entry for
    rank x.shape[-2].
    """
    nl, n = x.shape[-2], x.shape[-1]
    x = x.to(torch.complex64)
    dev = x.device
    if pmi is None:
        if nl != 4:
            raise ValueError("4-port CDD runs rank 4")
        d = table(("cdd4", n), dev, lambda: _cdd4_phase(n))
        wc = table(("cdd4_w", n), dev,
                   lambda: _CDD4_W[np.arange(n) % 4].transpose(1, 2, 0).copy())  # [p, k, n]
        u = _const("dft4", _DFT4, dev)
        # y(i) = W(i) D(i) U x(i); W carries the rank-4 1/2 normalization
        s = torch.matmul(u, x) * d
        return sum(wc[:, k] * s[..., None, k, :] for k in range(4)) / 2.0
    return torch.matmul(_const(("w4", pmi, nl), codebook_4port(pmi, nl), dev), x)


def mmse_sm_4port(y, h, noise_var, pmi: int | None = None, n_layers: int = 4):
    """MMSE detection for 4-port SM: y [..., nrx, n], h [..., nrx, 4, n].

    Folds the precoder into the channel and solves the nl x nl normal
    equations per RE (one batched `torch.linalg.solve_ex`, which checks
    nothing on the host).  Returns (x [..., nl, n], gain [..., nl, n]).
    """
    n = y.shape[-1]
    h = h.to(torch.complex64)
    dev = h.device
    if pmi is None:
        if n_layers != 4:
            raise ValueError("4-port CDD runs rank 4")
        m = table(("cdd4_m", n), dev,
                  lambda: _cdd4_matrix(n).transpose(1, 2, 0).copy())  # [p, l, n]
    else:
        w = _const(("w4", pmi, n_layers), codebook_4port(pmi, n_layers), dev)
        m = w[:, :, None]  # [p, l, 1]
    heff = sum(h[..., :, p, None, :] * m[p] for p in range(4))  # [..., r, l, n]
    hh = torch.conj(heff.transpose(-3, -2))  # [..., l, r, n]
    nrx = heff.shape[-3]
    a = sum(hh[..., :, r, None, :] * heff[..., None, r, :, :] for r in range(nrx))
    nv = _nv(noise_var, dev)
    nl = heff.shape[-2]
    a = a + nv * torch.eye(nl, dtype=a.dtype, device=dev)[..., None]
    z = (hh * y.to(torch.complex64)[..., None, :, :]).sum(-2)  # [..., l, n]
    # batched solve: the RE axis moves into the batch
    am = torch.movedim(a, -1, -3)  # [..., n, l, m]
    zm = torch.movedim(z, -1, -2)[..., None]  # [..., n, l, 1]
    xm = torch.linalg.solve_ex(am, zm)[0][..., 0]  # [..., n, l]
    x = torch.movedim(xm, -1, -2)
    gain = torch.real(torch.diagonal(a, dim1=-3, dim2=-2)).transpose(-1, -2) - nv
    return x, gain


# ------------------------------------------------------------- 4-port SFBC-FSTD
def alamouti_encode_4tx(x):
    """SFBC-FSTD: x [..., n] -> per-port symbols [..., 4, n].

    36.211 §6.3.4.3 (4 antenna ports, precoding.c srsran_precoding_diversity
    nof_ports==4): quadruple (x0..x3) occupies 4 REs; ports (0,2) carry an
    Alamouti pair on the first two REs, ports (1,3) on the last two; the
    other ports transmit zero there (frequency-switched diversity).  A
    trailing n%4==2 remainder is sent as a plain 2-port pair on (0,2), as
    the C library does.
    """
    n = x.shape[-1]
    m = n - n % 4
    q = x[..., :m].reshape(x.shape[:-1] + (m // 4, 4))
    x0, x1, x2, x3 = (q[..., i] for i in range(4))
    zero = torch.zeros_like(x0)
    c = torch.conj
    p0 = torch.stack([x0, x1, zero, zero], -1)
    p1 = torch.stack([zero, zero, x2, x3], -1)
    p2 = torch.stack([-c(x1), c(x0), zero, zero], -1)
    p3 = torch.stack([zero, zero, -c(x3), c(x2)], -1)
    out = torch.stack([p0, p1, p2, p3], -3)
    out = out.reshape(x.shape[:-1] + (4, m)) / math.sqrt(2.0)
    if n % 4:
        tail = alamouti_encode_2tx(x[..., m:])  # [..., 2, rem] on ports 0, 2
        zt = torch.zeros_like(tail[..., 0, :])
        tail4 = torch.stack([tail[..., 0, :], zt, tail[..., 1, :], zt], -2)
        out = torch.cat([out, tail4], -1)
    return out


def alamouti_decode_4tx(y, h, noise_var=0.0):
    """SFBC-FSTD combine: y [..., n], h [..., 4 ports, n] -> (x, gain).

    Each RE pair is a standard Alamouti decode against the port pair that
    was active there ((0,2) then (1,3) alternating); gain is the per-RE
    diversity channel power for LLR weighting (predecoding_diversity).
    """
    n = y.shape[-1]
    m = n - n % 4
    lead = y.shape[:-1]
    yq = y[..., :m].reshape(lead + (m // 4, 2, 2))
    hq = h[..., :m].reshape(h.shape[:-1] + (m // 4, 2, 2))
    # first RE pair uses ports (0, 2); second uses (1, 3)
    ya = yq[..., 0, :].reshape(lead + (m // 2,))
    yb = yq[..., 1, :].reshape(lead + (m // 2,))
    ha0 = hq[..., 0, :, 0, :].reshape(ya.shape)
    ha2 = hq[..., 2, :, 0, :].reshape(ya.shape)
    hb1 = hq[..., 1, :, 1, :].reshape(ya.shape)
    hb3 = hq[..., 3, :, 1, :].reshape(ya.shape)
    xa = alamouti_decode_2tx(ya, ha0, ha2, noise_var)
    xb = alamouti_decode_2tx(yb, hb1, hb3, noise_var)
    ga = (torch.abs(ha0) ** 2 + torch.abs(ha2) ** 2) / 2
    gb = (torch.abs(hb1) ** 2 + torch.abs(hb3) ** 2) / 2
    quad = lead + (m // 4, 2)
    xq = torch.stack([xa.reshape(quad), xb.reshape(quad)], -2)
    # each pair's gain is the mean over its two REs
    gq = torch.stack([ga.reshape(quad).mean(-1, keepdim=True).expand(quad),
                      gb.reshape(quad).mean(-1, keepdim=True).expand(quad)], -2)
    x = xq.reshape(lead + (m,))
    g = gq.reshape(lead + (m,))
    if n % 4:
        xt = alamouti_decode_2tx(y[..., m:], h[..., 0, m:], h[..., 2, m:], noise_var)
        gt = (torch.abs(h[..., 0, m:]) ** 2 + torch.abs(h[..., 2, m:]) ** 2) / 2
        x = torch.cat([x, xt], -1)
        g = torch.cat([g, gt], -1)
    return x, g


# ------------------------------------------------ transmit diversity on a grid
def diversity_put(flat, idx, sym, nof_ports: int, add: bool = False):
    """Write (or add) symbols sym [..., n] at the flat RE indices idx (any
    shape ending in n) of per-port grids flat [..., nports, nsym*nre], in
    place: port 0 alone, 2-port SFBC or 4-port SFBC-FSTD."""
    if nof_ports == 1:
        tx = sym[..., None, :]
    elif nof_ports == 2:
        tx = alamouti_encode_2tx(sym)
    elif nof_ports == 4:
        tx = alamouti_encode_4tx(sym)
    else:
        raise ValueError(f"bad port count {nof_ports}")
    for p in range(nof_ports):
        if add:
            flat[..., p, idx] += tx[..., p, :]
        else:
            flat[..., p, idx] = tx[..., p, :]


def diversity_combine(y, cef, idx, nof_ports: int):
    """Symbol estimates and per-RE gain of REs y [..., n] received through
    the per-port channel cef [..., nports, nsym*nre] at the flat indices idx
    (any shape ending in n): zero forcing and |h|^2 for 1 port, SFBC
    combining for 2, SFBC-FSTD for 4."""
    if nof_ports == 1:
        h = cef[..., 0, :][..., idx]
        return equalize_zf(y, h), torch.abs(h) ** 2
    if nof_ports == 2:
        h0, h1 = cef[..., 0, :][..., idx], cef[..., 1, :][..., idx]
        return (alamouti_decode_2tx(y, h0, h1),
                (torch.abs(h0) ** 2 + torch.abs(h1) ** 2) / 2)
    if nof_ports == 4:
        # cef[..., idx] is [..., 4, *idx.shape]: the port axis goes next to the REs
        return alamouti_decode_4tx(y, torch.movedim(cef[..., idx], -idx.dim() - 1, -2))
    raise ValueError(f"bad port count {nof_ports}")
