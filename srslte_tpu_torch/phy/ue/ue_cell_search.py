"""Cell search over a sample stream (ue_cell_search.c equivalent).

Reference behavior: lib/src/phy/ue/ue_cell_search.c srsran_ue_cellsearch_scan
(:260): loop 3 N_id_2 hypotheses x N 5-ms windows, count peak agreement, pick
the mode.

The stream is cut into a batch of half-frame windows (plus a four-symbol
halo so the SSS preceding an end-of-window PSS stays visible) and sync_find
evaluates every window and every hypothesis in one pass; the vote is an
`index_add_` over 505 bins (504 cell ids and one for invalid windows).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..._device import as_tensor, table, take
from ...utils.jit import lazy_jit
from ..common.params import OfdmParams
from ..sync.sync import SyncResult, sync_find

HALF_FRAME_MS = 5


class CellSearchResult(NamedTuple):
    cell_id: object  # int32 scalar (-1 if nothing found)
    n_id_1: object
    n_id_2: object
    cfo: object  # float32, subcarrier units
    peak_offset: object  # int32: PSS symbol start within the stream
    votes: object  # int32: windows agreeing on cell_id
    metric: object  # float32: mean PSS metric of agreeing windows
    tdd: object = False  # bool: frame structure type 2 (majority vote)


@lazy_jit(static_argnums=(1, 2))
def cell_search(samples, params: OfdmParams | None = None,
                frame_type: str = "fdd", device=None) -> CellSearchResult:
    """Search a 1-D sample stream [L] for the strongest cell.

    The stream is cut into floor(L/half_frame)-1 overlapping windows of
    half_frame + margin samples, so every PSS occurrence lands fully inside
    some window.  All windows are processed batched; the result is the
    majority cell id among windows whose SSS decoded to a valid N_id_1
    (ties to the lowest cell id, as `jnp.argmin` takes the first minimum).
    """
    samples = as_tensor(samples, device)
    dev = samples.device
    p = params or OfdmParams(6)
    half = p.srate * HALF_FRAME_MS // 1000
    margin = p.symbol_sz * 4
    n_win = int(samples.shape[-1]) // half - 1
    if n_win < 1:
        raise ValueError("need at least 2 half-frames of samples")
    idx = table(("cell_search_win", p, n_win), dev, lambda: (
        np.arange(n_win)[:, None] * half + np.arange(half + margin)[None, :]))
    wins = samples[..., idx]  # [n_win, half+margin]

    r: SyncResult = sync_find(wins, p, frame_type)

    valid = r.n_id_1 >= 0
    cid = torch.where(valid, r.cell_id, 504).long()
    counts = torch.zeros(505, dtype=torch.int32, device=dev).index_add_(
        0, cid, torch.ones_like(cid, dtype=torch.int32))
    bins = torch.arange(505, device=dev)
    best = torch.argmin(torch.where(bins < 504, -counts, 1)).to(torch.int32)
    votes = take(counts, best)
    agree = (r.cell_id == best) & valid
    w = agree.to(torch.float32)
    wsum = torch.clamp(torch.sum(w), min=1e-9)
    cfo = torch.sum(r.cfo * w) / wsum
    metric = torch.sum(r.pss_metric * w) / wsum
    # representative timing: the agreeing window with the best PSS metric
    score = torch.where(agree, r.pss_metric, -1.0)
    k = torch.argmax(score)
    offset = take(idx[:, 0], k) + take(r.peak_offset, k)
    found = votes > 0
    tdd = torch.sum(torch.where(agree, r.tdd, False)) * 2 > votes
    none = torch.full((), -1, dtype=torch.int32, device=dev)
    return CellSearchResult(
        cell_id=torch.where(found, best, none),
        n_id_1=torch.where(found, torch.div(best, 3, rounding_mode="floor"), none),
        n_id_2=torch.where(found, best % 3, none),
        cfo=cfo, peak_offset=offset.to(torch.int32),
        votes=votes, metric=metric, tdd=tdd)
