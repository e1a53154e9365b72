"""Process/system resource metrics (sys_metrics_processor.cc equivalent).

Reference behavior: lib/src/system/sys_metrics_processor.cc — samples
/proc/self/stat (utime+stime deltas over wall time -> CPU %), /proc/self/
status (VmRSS -> memory), and /proc/meminfo, feeding the metrics hub as
another producer.  Pure host-side; plugs into utils.metrics.MetricsHub via
``hub.add_producer("sys", SysMetrics().get_metrics)``.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field


def _read_self_stat() -> tuple[float, int]:
    """(utime+stime in seconds, num_threads) from /proc/self/stat."""
    with open("/proc/self/stat") as f:
        raw = f.read()
    # field 2 (comm) may contain spaces; it is parenthesized — split after it
    rest = raw[raw.rindex(")") + 2 :].split()
    hz = os.sysconf("SC_CLK_TCK")
    utime, stime = int(rest[11]), int(rest[12])  # fields 14, 15 (1-based)
    threads = int(rest[17])  # field 20
    return (utime + stime) / hz, threads


def _rss_mb() -> float:
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024.0
    return 0.0


def _meminfo_mb(key: str) -> float:
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) / 1024.0
    return 0.0


@dataclass
class SysMetrics:
    """CPU/memory sampler with delta-based CPU utilisation."""

    _last_cpu_s: float = 0.0
    _last_wall: float = field(default_factory=time.perf_counter)
    _primed: bool = False

    def get_metrics(self) -> dict:
        cpu_s, threads = _read_self_stat()
        now = time.perf_counter()
        dt = max(now - self._last_wall, 1e-9)
        cpu_pct = 0.0 if not self._primed else \
            100.0 * (cpu_s - self._last_cpu_s) / dt
        self._last_cpu_s, self._last_wall, self._primed = cpu_s, now, True
        return {
            "cpu_percent": round(max(cpu_pct, 0.0), 2),
            "threads": threads,
            "proc_rss_mb": round(_rss_mb(), 2),
            "sys_mem_free_mb": round(_meminfo_mb("MemAvailable"), 2),
        }
