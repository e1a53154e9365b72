"""Chrome-trace event tracing (srslog event_trace equivalent).

Reference behavior: lib/src/srslog/event_trace.cpp — begin/end + complete
duration events emitted as Chrome trace JSON (chrome://tracing loadable),
hooked on hot paths (SURVEY.md §5.1).  Enabled explicitly like the
reference's ENABLE_SRSLOG_TRACING compile flag.
"""

from __future__ import annotations

import json
import os
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field


@dataclass
class Tracer:
    enabled: bool = False
    events: list = field(default_factory=list)
    _lock: threading.Lock = field(default_factory=threading.Lock)
    _t0: float = field(default_factory=time.perf_counter)

    def _us(self) -> int:
        return int((time.perf_counter() - self._t0) * 1e6)

    def complete(self, category: str, name: str, dur_us: int, ts_us=None,
                 **args):
        if not self.enabled:
            return
        with self._lock:
            self.events.append({
                "ph": "X", "cat": category, "name": name,
                "ts": self._us() - dur_us if ts_us is None else ts_us,
                "dur": dur_us, "pid": os.getpid(),
                "tid": threading.get_ident() % 100000, "args": args})

    def instant(self, category: str, name: str, **args):
        if not self.enabled:
            return
        with self._lock:
            self.events.append({
                "ph": "i", "cat": category, "name": name, "ts": self._us(),
                "pid": os.getpid(), "tid": threading.get_ident() % 100000,
                "s": "t", "args": args})

    @contextmanager
    def span(self, category: str, name: str, **args):
        if not self.enabled:
            yield
            return
        t0 = self._us()
        yield
        self.complete(category, name, self._us() - t0, ts_us=t0, **args)

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump({"traceEvents": self.events}, f)


TRACER = Tracer()  # global instance, like the reference's singleton


def enable_tracing():
    TRACER.enabled = True


def trace_span(category: str, name: str, **args):
    return TRACER.span(category, name, **args)
