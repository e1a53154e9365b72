"""Streaming sample-stream alignment: FIND -> TRACK (ue_sync.c equivalent).

Reference behavior: lib/src/phy/ue/ue_sync.c: srsran_ue_sync_zerocopy (:726):
FIND state runs a full PSS/SSS search; TRACK re-correlates the PSS at the
expected offset each half-frame (:618 track_peak_ok), nudges the sample
offset, tracks CFO (CP + PSS estimates blended), and counts the subframe
index; file-mode replay (:734) reads from a sample source instead of a radio.

The tracker steps a BLOCK of subframes: the whole block is CFO-corrected and
cut into subframes, the PSS windows of the block's sync subframes (0 and 5)
are gathered and correlated, and the CP residual is estimated, in one batched
pass on the device; the host reads back the PSS powers and the residual and
advances `UeSyncState` (offset, cfo, subframe counter) once per block, where
the C library mutates `srsran_ue_sync_t` per millisecond.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from ..._device import as_tensor, table
from ...utils.jit import lazy_jit
from ..common.params import Cell, OfdmParams
from ..sync.cfo import cfo_correct, cfo_estimate_cp
from ..sync.pss import pss_find
from ..sync.sync import sync_find, window_slice

TRACK_WIN = 8  # +- samples searched around the expected PSS position


@lazy_jit(static_argnums=(1,))
def _slice_prefix(x, n: int):
    """x[..., :n] as a new tensor."""
    return x[..., :n].clone()


@lazy_jit(static_argnums=(3, 4, 5))
def _track_dev(samples, pos, cfo, params: OfdmParams, n_sf: int,
               sync_offsets: tuple):
    """Device side of track_block: one batched pass per block.

    samples: the stream (1-D, on the device); pos and cfo: traced (0-d
    tensors on the card, so that every block replays one graph);
    sync_offsets: the subframes of the block that contain PSS.  Returns (sfs [n_sf, sf_len],
    pss_power [n_sync, 3, 2*WIN+1], cp_cfo).
    """
    p = params
    n = p.symbol_sz
    need = n_sf * p.sf_len + TRACK_WIN + n
    raw = window_slice(samples, pos, need)  # placed as the JAX package places it
    corr = cfo_correct(raw, cfo, n)
    sfs = corr[: n_sf * p.sf_len].reshape(n_sf, p.sf_len)
    if sync_offsets:
        # the PSS windows: +- TRACK_WIN around each expected PSS start
        idx = table(("track_pss", p, sync_offsets), samples.device, lambda: np.stack(
            [i * p.sf_len + p.slot_len - n - TRACK_WIN + np.arange(2 * TRACK_WIN + n)
             for i in sync_offsets]))
        pss_pw = pss_find(corr[idx], n, norm=False)
    else:
        pss_pw = torch.zeros((0, 3, TRACK_WIN + 1), device=samples.device)
    resid = cfo_estimate_cp(sfs[0], p)
    return sfs, pss_pw, resid


@dataclass(frozen=True)
class UeSyncState:
    cell_id: int
    sf_idx: int  # subframe index of the NEXT subframe to be emitted
    stream_pos: int  # sample index of that subframe in the stream
    cfo: float  # subcarrier units
    in_sync: bool = True
    frames: int = 0  # half-frames tracked


@dataclass(frozen=True)
class UeSync:
    cell: Cell

    @property
    def params(self) -> OfdmParams:
        return self.cell.ofdm

    # -- FIND -----------------------------------------------------------------
    def find(self, samples, device=None) -> UeSyncState | None:
        """Full sync over >= 5 ms + 1 subframe of samples (one batched pass,
        then 4 scalars read back)."""
        samples = as_tensor(samples, device)
        p = self.params
        half = p.srate * 5 // 1000
        if samples.shape[-1] < half + p.sf_len:
            raise ValueError("need at least 5 ms + 1 subframe for FIND")
        r = sync_find(_slice_prefix(samples, half + 4 * p.symbol_sz), p)
        if int(r.n_id_1) < 0:
            return None
        # emit from the detected PSS subframe
        return UeSyncState(cell_id=int(r.cell_id), sf_idx=5 if bool(r.sf5) else 0,
                           stream_pos=int(r.sf_start), cfo=float(r.cfo))

    # -- TRACK ----------------------------------------------------------------
    def track_block(self, samples, state: UeSyncState, n_sf: int, device=None):
        """Emit n_sf aligned, CFO-corrected subframes from the stream.

        samples: 1-D stream covering [state.stream_pos, ... + n_sf*sf_len +
        margin].  Returns (subframes [n_sf, sf_len] complex64 on the device,
        new state).  One PSS re-correlation per contained sync subframe
        updates the offset estimate; CP-based CFO refines the frequency
        estimate.
        """
        samples = as_tensor(samples, device)
        p = self.params
        n = p.symbol_sz
        pos = state.stream_pos
        need = n_sf * p.sf_len + TRACK_WIN + n
        if samples.shape[-1] < pos + need:
            raise ValueError("not enough samples for the requested block")
        sync_offsets = tuple(i for i in range(n_sf)
                             if (state.sf_idx + i) % 5 == 0)
        sfs, pss_pw, resid = _track_dev(samples, pos, state.cfo, p, n_sf,
                                        sync_offsets)
        # PSS tracking on sync subframes (sf_idx % 5 == 0)
        nid2 = state.cell_id % 3
        pw = pss_pw[:, nid2].cpu().numpy()  # [n_sync, 2*WIN+1]
        offs = list(np.argmax(pw, axis=-1) - TRACK_WIN) if len(pw) else []
        drift = int(np.median(offs)) if offs else 0

        # CFO refinement from the CP of the first subframe (residual)
        new_cfo = state.cfo + 0.5 * float(resid)

        in_sync = abs(drift) <= TRACK_WIN
        new = replace(state,
                      sf_idx=(state.sf_idx + n_sf) % 10,
                      stream_pos=pos + n_sf * p.sf_len + drift,
                      cfo=new_cfo,
                      in_sync=in_sync,
                      frames=state.frames + n_sf // 5)
        return sfs, new
