"""The profiler trace of the traced stretch, reduced to what the per-layer
metrics read.

The trace is torch.profiler's Chrome trace (`export_chrome_trace`): host
ranges of the benchmark's own spans (`record_function("bench.<name>")`,
category "user_annotation"), CUDA runtime calls (category "cuda_runtime"
or "cuda_driver") and device activity (kernels, copies, sets) on one
clock, in microseconds.  A device operation belongs to the span in which
the host made the runtime call it correlates with, so a CUDA graph
replay's kernels belong to the span of the call that replayed the graph.
"""

from __future__ import annotations

import bisect
import json
from collections import defaultdict

PREFIX = "bench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
OUTER = "dispatch"


class _Spans:
    """Non-overlapping host ranges, found by time."""

    def __init__(self, ranges):
        self.ranges = sorted(ranges)
        self.starts = [r[0] for r in self.ranges]

    def at(self, t: float):
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and t <= self.ranges[i][1]:
            return self.ranges[i][2]
        return None


def merge(intervals):
    """The union of (start, end) intervals, as sorted disjoint intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """Device operations with the span each belongs to, over the window
    from the first dispatch span's start to the last one's end."""

    def __init__(self, events: list):
        spans = [(e["ts"], e["ts"] + e["dur"], e["name"][len(PREFIX):]) for e in events
                 if e.get("cat") == "user_annotation" and e.get("name", "").startswith(PREFIX)]
        outer = [s for s in spans if s[2] == OUTER]
        self.outer = _Spans(outer)
        self.inner = _Spans([s for s in spans if s[2] != OUTER])
        self.window = ((min(s[0] for s in outer), max(s[1] for s in outer)) if outer
                       else (0.0, 0.0))
        launch = {}
        for e in events:
            if e.get("cat") in RUNTIME_CATS and "correlation" in e.get("args", {}):
                launch[e["args"]["correlation"]] = (e["ts"], e["name"])
        self.ops = []  # (name, start us, end us, span or None, from a graph launch)
        for e in events:
            if e.get("cat") not in DEVICE_CATS or e.get("ph") != "X":
                continue
            host = launch.get(e.get("args", {}).get("correlation"))
            span = self.span_at(host[0]) if host else None
            graphed = bool(host) and "GraphLaunch" in host[1]
            self.ops.append((e["name"], e["ts"], e["ts"] + e["dur"], span, graphed))

    @classmethod
    def load(cls, path) -> "Trace":
        with open(path) as f:
            data = json.load(f)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    def span_at(self, t: float):
        return self.inner.at(t) or self.outer.at(t)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def graph_ops(self) -> int:
        """Device operations that CUDA graph replays launched."""
        return sum(1 for op in self.ops if op[4])

    def _inside(self):
        w0, w1 = self.window
        for name, s, e, span, _ in self.ops:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                yield name, s, e, span

    def busy(self):
        """The union of the device's operations inside the window."""
        return merge((s, e) for _, s, e, _ in self._inside())

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) * 1e-6

    def span_device_s(self, span: str) -> float:
        """Seconds of device operations that belong to `span`."""
        return sum(e - s for _, s, e, sp in self._inside() if sp == span) * 1e-6

    def kernels(self, part: str):
        """(count, seconds) of the operations whose name holds `part`."""
        durs = [e - s for name, s, e, _ in self._inside() if part in name]
        return len(durs), sum(durs) * 1e-6

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the n device operations that took most time."""
        by = defaultdict(float)
        for name, s, e, _ in self._inside():
            by[name] += (e - s) * 1e-6
        return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10):
        """[[span the host was in, seconds]] of the n longest stretches of the
        window with nothing on the device ("between dispatches" outside
        every span)."""
        w0, w1 = self.window
        gaps, t = [], w0
        for s, e in self.busy() + [[w1, w1]]:
            if s > t:
                gaps.append((s - t, t))
            t = max(t, e)
        gaps.sort(key=lambda g: (-g[0], g[1]))
        return [[self.span_at(start) or "between dispatches", length * 1e-6]
                for length, start in gaps[:n]]
