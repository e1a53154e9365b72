"""The window's arithmetic: the end-to-end metrics from the host times of
the window's dispatches."""

from __future__ import annotations

import math


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest value that at
    least 95 % of the values do not exceed."""
    s = sorted(values)
    if not s:
        raise ValueError("no values")
    return s[max(0, math.ceil(0.95 * len(s)) - 1)]


def end_to_end(starts, ends, ttis_per_dispatch: int, peak_bytes: int, t0: float) -> dict:
    """The end-to-end metrics of a window of closed-loop dispatches, each
    from its start (its batch on the card) to its outputs on the host:
    every TTI of every dispatch over the time from the first start to the
    last end; the 95th percentile of all dispatch times; the allocator's
    peak; and the set-up, from the process's start (`t0`) to the first
    dispatch's start.  Times in seconds on one clock."""
    if len(starts) != len(ends) or not starts:
        raise ValueError("a window needs at least one dispatch, each with a start and an end")
    span = ends[-1] - starts[0]
    return {"tti_per_s": len(starts) * ttis_per_dispatch / span,
            "dispatch_p95_ms": p95([e - s for s, e in zip(starts, ends)]) * 1e3,
            "peak_device_mb": peak_bytes / 1e6,
            "setup_s": starts[0] - t0}
