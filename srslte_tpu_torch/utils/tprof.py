"""Timing probes with percentile statistics (time_prof.h equivalent).

Reference behavior: lib/include/srsran/common/time_prof.h:38-115 — RAII
tprof probes gated by ENABLE_TIMEPROF, accumulating per-call durations into
average/max/min and sliding-window percentile trackers, dumped on demand.

Device work is asynchronous, so a probe around a call that launches work
on the card measures the launch unless the caller waits for the result;
`measure()` takes an optional `sync` callable (e.g.
``lambda r: torch.cuda.synchronize()``) so probes on device paths time
real work.
Probes are process-local and cheap when disabled (a bool check), like the
reference's compile-time gate.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

_ENABLED = os.environ.get("SRSLTE_TPU_TIMEPROF", "0") == "1"


def set_enabled(on: bool):
    global _ENABLED
    _ENABLED = on


@dataclass
class TProf:
    """One named probe: collects call durations, reports percentiles."""

    name: str
    capacity: int = 4096  # sliding window (time_prof.h sliding_window_stats)
    _durs: list = field(default_factory=list)
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0
    min_s: float = float("inf")

    def add(self, dur_s: float):
        self.count += 1
        self.total_s += dur_s
        self.max_s = max(self.max_s, dur_s)
        self.min_s = min(self.min_s, dur_s)
        self._durs.append(dur_s)
        if len(self._durs) > self.capacity:
            del self._durs[: len(self._durs) - self.capacity]

    @contextmanager
    def __call__(self):
        if not _ENABLED:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(time.perf_counter() - t0)

    def measure(self, fn, *args, sync=None):
        """Run fn(*args) under the probe; `sync` materializes async work."""
        if not _ENABLED:
            return fn(*args)
        t0 = time.perf_counter()
        out = fn(*args)
        if sync is not None:
            sync(out)
        self.add(time.perf_counter() - t0)
        return out

    def _pct(self, q: float) -> float:
        if not self._durs:
            return 0.0
        s = sorted(self._durs)
        return s[min(len(s) - 1, int(q * len(s)))]

    def stats(self) -> dict:
        n = max(self.count, 1)
        return {
            "name": self.name,
            "count": self.count,
            "mean_us": self.total_s / n * 1e6,
            "min_us": (0.0 if self.count == 0 else self.min_s * 1e6),
            "max_us": self.max_s * 1e6,
            "p50_us": self._pct(0.50) * 1e6,
            "p90_us": self._pct(0.90) * 1e6,
            "p99_us": self._pct(0.99) * 1e6,
        }


_REGISTRY: dict[str, TProf] = {}


def probe(name: str, capacity: int = 4096) -> TProf:
    """Get-or-create a named probe (the reference's static tprof objects)."""
    p = _REGISTRY.get(name)
    if p is None:
        p = _REGISTRY[name] = TProf(name, capacity)
    return p


def report_all() -> list[dict]:
    """Stats of every registered probe that fired (dump-on-exit analog)."""
    return [p.stats() for p in _REGISTRY.values() if p.count]


def reset_all():
    _REGISTRY.clear()
