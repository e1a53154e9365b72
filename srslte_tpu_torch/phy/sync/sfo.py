"""Sampling-frequency-offset estimation (sfo.c equivalent).

Reference behavior: lib/src/phy/sync/sfo.c: SFO from the drift of PSS peak
timing across frames (srsran_sfo_estimate: offset deltas over elapsed time).

Host code: a least-squares slope over the whole history of (frame, offset)
pairs in one shot instead of the C library's pairwise running average.
"""

from __future__ import annotations

import numpy as np


def sfo_estimate(frame_idx, peak_offsets, frame_len: int, srate: int) -> float:
    """SFO in Hz from PSS peak positions.

    frame_idx: [n] frame counters; peak_offsets: [n] detected PSS offsets in
    samples (same reference point each frame).  Returns the clock offset in
    Hz (samples drifted per second); divide by srate for the ppm ratio.
    """
    f = np.asarray(frame_idx, np.float64)
    o = np.asarray(peak_offsets, np.float64)
    if len(f) < 2:
        return 0.0
    slope = np.polyfit(f, o, 1)[0]  # samples per frame
    frame_s = frame_len / srate
    return float(slope / frame_s)


def sfo_to_ppm(sfo_hz: float, srate: int) -> float:
    return 1e6 * sfo_hz / srate
