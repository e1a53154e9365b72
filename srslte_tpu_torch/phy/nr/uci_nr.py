"""NR UCI coding (38.212 §6.3.1.2-5, uci_nr.c equivalent).

Reference behavior: lib/src/phy/phch/uci_nr.c — 1-2 bits repetition /
simplex, 3-11 bits the (32, A) Reed-Muller block code, 12-1706 bits
CA-polar (CRC6 with 3 parity-check bits for A < 20, CRC11 above, two-segment
split for large payloads, n_max = 10, triangular channel interleaver
I_BIL = 1; polar_rm.c ch_interleaver_rm_tx:510).

The coded bits are made on the device; the decoder reads its result back
once (the list decoder's candidates of every segment, decoded as one batch)
and selects with the CRC on the host, as the reference does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..._device import as_tensor, table
from ..fec.block import block_decode, block_encode
from ..fec.crc import NR_CRC6, NR_CRC11, crc_bits
from ..fec.polar import PolarCode, polar_decode_list, polar_encode


def crc_len(a: int) -> int:
    return 0 if a <= 11 else (6 if a < 20 else 11)


@functools.lru_cache(maxsize=None)
def ch_interleave_idx(e: int) -> np.ndarray:
    """Triangular channel interleaver: f[i] = e_in[idx[i]] (§5.4.1.3)."""
    t = 1
    s = 1
    while s < e:
        t += 1
        s += t
    idx = []
    for r in range(t):
        i_in = r
        for c in range(t - r):
            if i_in < e:
                idx.append(i_in)
                i_in += t - c
            else:
                break
    out = np.array(idx, np.int64)
    assert len(out) == e
    return out


def _polar_params(a: int, e: int) -> tuple[int, int, int, int]:
    """(C, A_prime, K_r, E_r) segmentation (uci_nr.c:646-668)."""
    i_seg = 1 if ((a >= 360 and e >= 1088) or a >= 1013) else 0
    c = 2 if i_seg else 1
    a_prime = -(-a // c) * c
    k_r = a_prime // c + crc_len(a)
    return c, a_prime, k_r, e // c


def uci_encode(bits, e: int, device=None) -> torch.Tensor:
    """UCI payload [A] -> coded bits [e] uint8 on the device (QPSK bit stream)."""
    dev = as_tensor(bits, device).device
    bits = np.asarray(as_tensor(bits, "cpu"), np.uint8)
    a = len(bits)
    if a <= 11:
        if a == 1:
            out = np.tile(bits, e)[:e]
        elif a == 2:
            c = np.array([bits[0], bits[1], bits[0] ^ bits[1]], np.uint8)
            out = np.tile(c, -(-e // 3))[:e]
        else:
            out = np.tile(block_encode(bits, 32).astype(np.uint8), -(-e // 32))[:e]
        return as_tensor(out, dev)
    c, a_prime, k_r, e_r = _polar_params(a, e)
    poly = NR_CRC6 if crc_len(a) == 6 else NR_CRC11
    padded = np.concatenate([np.zeros(a_prime - a, np.uint8), bits])
    segs = np.stack([padded[r * (a_prime // c) : (r + 1) * (a_prime // c)] for r in range(c)])
    cseg = np.concatenate([segs, crc_bits(segs, *poly)], -1)
    code = PolarCode(K=k_r, E=e_r, n_max=10, with_pc=True)
    f = polar_encode(cseg, code, device=dev)
    il = table(("uci_ch_il", e_r), f.device, lambda: ch_interleave_idx(e_r))
    return f[..., il].reshape(-1)  # I_BIL = 1


def uci_decode(llr, a: int, list_size: int = 8, device=None):
    """LLRs [e] (positive => bit 1) -> (bits [a] numpy uint8, ok).

    1-11 bits: ML block/repetition decode (ok = correlation sane);
    12+: CA-SCL with per-candidate CRC check.
    """
    llr = as_tensor(llr, device)
    e = llr.shape[-1]
    if a == 1:
        s = torch.sum(llr)
        return np.array([int(s.item() > 0)], np.uint8), True
    if a == 2:
        acc = np.zeros(3)
        l_np = llr.cpu().numpy()
        for i in range(e):
            acc[i % 3] += l_np[i]
        c0, c1, c2 = acc > 0
        # majority vote consistent with c2 = c0 ^ c1
        if (int(c0) ^ int(c1)) != int(c2):
            # flip the weakest decision
            weakest = int(np.argmin(np.abs(acc)))
            vals = [int(c0), int(c1), int(c2)]
            vals[weakest] ^= 1
            c0, c1, _ = vals
        return np.array([int(c0), int(c1)], np.uint8), True
    if a <= 11:
        bits, corr = block_decode(llr, a)  # folds repetitions internally
        host = torch.cat([bits.to(torch.float32), corr.reshape(1)]).cpu().numpy()
        return host[:a].astype(np.uint8), bool(host[a] > 0)
    c, a_prime, k_r, e_r = _polar_params(a, e)
    poly = NR_CRC6 if crc_len(a) == 6 else NR_CRC11
    code = PolarCode(K=k_r, E=e_r, n_max=10, with_pc=True)
    inv = table(("uci_ch_il_inv", e_r), llr.device,
                lambda: np.argsort(ch_interleave_idx(e_r)))
    lseg = llr[: c * e_r].reshape(c, e_r)[:, inv]
    cands = polar_decode_list(lseg, code, L=list_size).cpu().numpy()  # [C, L, K_r]
    segs = []
    for r in range(c):
        got = None
        for cand in cands[r]:
            payload, crc = cand[: k_r - poly[1]], cand[k_r - poly[1]:]
            if np.array_equal(crc_bits(payload, *poly), crc):
                got = payload
                break
        if got is None:
            return np.zeros(a, np.uint8), False
        segs.append(got)
    full = np.concatenate(segs)
    return full[a_prime - a :], True
