"""Metrics hub: periodic polling fan-out (metrics_hub.h equivalent).

Reference behavior: lib/include/srsran/common/metrics_hub.h — a thread polls
each producer's get_metrics() every period and fans the snapshot out to N
listeners; stdout / CSV / JSON listeners as in srsue/srsenb
(metrics_stdout.cc, metrics_csv.cc, metrics_json.cc).
"""

from __future__ import annotations

import csv
import json
import threading
import time
from dataclasses import dataclass, field


@dataclass
class MetricsHub:
    period_s: float = 1.0
    producers: dict = field(default_factory=dict)  # name -> get_metrics()
    listeners: list = field(default_factory=list)  # callables(snapshot)
    _thread: threading.Thread | None = None
    _stop: threading.Event = field(default_factory=threading.Event)

    def add_producer(self, name: str, get_metrics):
        self.producers[name] = get_metrics

    def add_listener(self, fn):
        self.listeners.append(fn)

    def poll_once(self) -> dict:
        snap = {"ts": time.time()}
        for name, fn in self.producers.items():
            try:
                snap[name] = fn()
            except Exception as e:  # a broken producer must not kill the hub
                snap[name] = {"error": str(e)}
        for l in self.listeners:
            l(snap)
        return snap

    def start(self):
        self._stop.clear()

        def run():
            while not self._stop.wait(self.period_s):
                self.poll_once()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join()


class CsvListener:
    def __init__(self, path: str, fields: list):
        self.fields = fields
        self._f = open(path, "w", newline="")
        self._w = csv.writer(self._f)
        self._w.writerow(fields)

    def __call__(self, snap: dict):
        def get(path):
            cur = snap
            for part in path.split("."):
                cur = cur.get(part, {}) if isinstance(cur, dict) else ""
            return cur if not isinstance(cur, dict) else ""

        self._w.writerow([get(f) for f in self.fields])
        self._f.flush()

    def close(self):
        self._f.close()


class JsonLinesListener:
    def __init__(self, path: str):
        self._f = open(path, "w")

    def __call__(self, snap: dict):
        self._f.write(json.dumps(snap) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class StdoutTableListener:
    """Console table like srsue's metrics_stdout.cc: a header line every
    `header_every` rows, one fixed-width row per snapshot.

    fields: list of (column title, dotted snapshot path) pairs; missing
    values print as '-'.  Floats render with 3 significant digits the way
    the reference's float_to_string does.
    """

    def __init__(self, fields: list, header_every: int = 10, out=None):
        import sys

        self.fields = fields
        self.header_every = header_every
        self._out = out or sys.stdout
        self._n = 0
        self._w = [max(len(t), 8) for t, _ in fields]

    def _fmt(self, v) -> str:
        if v is None or v == "":
            return "-"
        if isinstance(v, float):
            return f"{v:.3g}"
        return str(v)

    def __call__(self, snap: dict):
        if self._n % self.header_every == 0:
            self._out.write(" ".join(t.rjust(w) for (t, _), w
                                     in zip(self.fields, self._w)) + "\n")
        row = []
        for (_, path), w in zip(self.fields, self._w):
            cur = snap
            for part in path.split("."):
                cur = cur.get(part) if isinstance(cur, dict) else None
            row.append(self._fmt(None if isinstance(cur, dict) else cur)
                       .rjust(w))
        self._out.write(" ".join(row) + "\n")
        self._out.flush()
        self._n += 1
