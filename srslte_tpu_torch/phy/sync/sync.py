"""Combined PSS+SSS synchronization (sync.c equivalent).

Reference behavior: lib/src/phy/sync/sync.c srsran_sync_find (:442): PSS
matched filter over the window, CFO estimate from the PSS symbol, SSS decode
one symbol earlier, cell id = 3*N_id_1 + N_id_2.

All three N_id_2 hypotheses and all 168 N_id_1 x {sf0, sf5} hypotheses are
evaluated by the batched functions of pss.py / sss.py.  Each window's PSS
and SSS symbols are gathered with index tensors, for all windows at once:
cell search over many windows is one pass with no loop over windows (the C
library loops hypotheses serially, ue_cell_search.c:260).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..._device import as_tensor
from ...utils.jit import lazy_jit
from ..common.params import OfdmParams
from .cfo import cfo_correct
from .pss import pss_cfo_compute, pss_find_peak
from .sss import sss_find


class SyncResult(NamedTuple):
    n_id_2: object  # int32 [...]
    n_id_1: object  # int32 [...] (-1 when SSS invalid)
    cell_id: object  # int32 [...]
    sf5: object  # bool [...]: True if the detected half-frame is subframe 5
    peak_offset: object  # int32 [...]: start of the PSS symbol (no CP)
    sf_start: object  # int32 [...]: start of subframe 0/5 (SSS subframe)
    cfo: object  # float32 [...], subcarrier units
    pss_metric: object  # float32 [...]
    sss_metric: object  # float32 [...]
    tdd: object = False  # bool [...]: frame structure type 2 detected


def window_slice(x, start, length: int):
    """x[..., s:s+length] for a start s that is an int (a view) or a tensor
    of x's batch shape, one start per batch element (one gather).  The start
    is placed as the JAX package's `lax.dynamic_slice_in_dim` places it: a
    negative start counts from the end (start + L), then the start is
    clamped into [0, L - length] so that the slice fits."""
    L = x.shape[-1]
    if isinstance(start, int):
        start = min(max(start + L if start < 0 else start, 0), L - length)
        return x[..., start : start + length]
    start = start.long()
    start = torch.clamp(torch.where(start < 0, start + L, start), 0, L - length)
    idx = start[..., None] + torch.arange(length, device=x.device)
    return torch.gather(x, -1, idx.expand(x.shape[:-1] + (length,)))


@lazy_jit(static_argnums=(1, 2))
def sync_find(samples, params: OfdmParams, frame_type: str = "fdd",
              device=None) -> SyncResult:
    """Find PSS/SSS in windows [..., L] sampled at params.srate.

    L should cover >= 1 subframe + 1 symbol of margin so the SSS symbol
    preceding a detected PSS is inside the window; detection near the very
    start of the window clamps (the metric reflects the bad fit).

    frame_type: "fdd" reads the SSS one symbol before the PSS (36.211 type
    1); "tdd" reads it three symbols back: SSS closes subframe 0/5 and the
    PSS sits in symbol 2 of subframe 1/6 (type 2); "auto" decodes both
    hypotheses and keeps the better SSS correlation, like the C library's
    blind frame-type detection (sync.c srsran_sync_set_frame_type /
    ue_sync.c frame_type detection loop).
    """
    if frame_type not in ("fdd", "tdd", "auto"):
        raise ValueError(f"frame_type {frame_type!r}")
    samples = as_tensor(samples, device).to(torch.complex64)
    n = params.symbol_sz
    cp1 = params.cp_lens_slot()[0]  # first-symbol CP
    cp2 = params.cp_lens_slot()[1]  # other-symbol CP
    slot = params.slot_len

    n_id_2, offset, pss_metric = pss_find_peak(samples, n)
    # SSS symbol start relative to the PSS symbol start per frame type
    d_fdd = cp2 + n
    d_tdd = cp1 + 2 * cp2 + 3 * n

    # PSS symbol -> CFO
    cfo = pss_cfo_compute(window_slice(samples, offset, n), n_id_2, n)

    def sss_at(delta):
        sss_sym = window_slice(samples, torch.clamp(offset.long() - delta, min=0), n)
        bins = torch.fft.fft(cfo_correct(sss_sym, cfo, n), dim=-1)
        d = torch.cat([bins[..., n - 31 :], bins[..., 1:32]], dim=-1)
        return sss_find(d, n_id_2)

    if frame_type == "auto":
        i1f, s5f, mf = sss_at(d_fdd)
        i1t, s5t, mt = sss_at(d_tdd)
        tdd = mt > mf
        n_id_1 = torch.where(tdd, i1t, i1f)
        sf5 = torch.where(tdd, s5t, s5f)
        sss_metric = torch.maximum(mf, mt)
    else:
        n_id_1, sf5, sss_metric = sss_at(d_tdd if frame_type == "tdd" else d_fdd)
        tdd = torch.full_like(sf5, frame_type == "tdd")

    # FDD: PSS closes slot 0 of subframe 0/5 -> its subframe starts one
    # slot minus (symbol without CP) before the PSS start.  TDD: the SSS
    # subframe 0/5 ENDS right after the SSS symbol, i.e. at
    # offset - d_tdd + n, so it starts one subframe earlier.
    sf_fdd = offset + n - slot
    sf_tdd = offset - d_tdd + n - params.sf_len
    sf_start = torch.where(tdd, sf_tdd, sf_fdd).to(torch.int32)
    cell_id = torch.where(n_id_1 >= 0, 3 * n_id_1 + n_id_2, -1)
    return SyncResult(n_id_2, n_id_1, cell_id.to(torch.int32), sf5,
                      offset, sf_start, cfo, pss_metric, sss_metric, tdd)
