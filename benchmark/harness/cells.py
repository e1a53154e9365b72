"""Cells found by name: BENCHMARK.json names each cell's configuration and
traffic mix; the files are found by those names.

- a configuration: the `file` that BENCHMARK.json gives it;
- a traffic mix: `benchmark/traffic/<traffic>.json`;
- a path (the port's entry calls for a family of deployments):
  `benchmark/paths/<config's "path">.py`;
- a per-layer metric's reader: `benchmark/layer_metrics/<metric>.py`, whose
  `read(ctx)` returns the value or None when it finds nothing to read.

A missing file raises FileNotFoundError naming what was looked for.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    path: object  # the path module
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)


def load_json(path: Path, what: str) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    return json.loads(path.read_text())


def load_module(path: Path, what: str):
    """The Python file `path` as a module of its own."""
    if not path.is_file():
        raise FileNotFoundError(f"{what}: no file {path}")
    name = "benchmark._loaded." + re.sub(r"\W", "_", str(path.relative_to(BENCH_DIR)))
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def traffic(name: str) -> dict:
    return load_json(BENCH_DIR / "traffic" / f"{name}.json", f"traffic mix {name!r}")


def path(name: str):
    return load_module(BENCH_DIR / "paths" / f"{name}.py", f"path {name!r}")


def reader(metric: str):
    """The `read` function of a per-layer metric."""
    return load_module(BENCH_DIR / "layer_metrics" / f"{metric}.py",
                       f"per-layer metric {metric!r}").read


def find(name: str, bench_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell `name` of BENCHMARK.json, with its files loaded."""
    bench = load_json(bench_file, "the benchmark")
    work = [w for w in bench["workloads"] if w["name"] == name]
    if not work:
        raise KeyError(f"no cell named {name!r} in {bench_file}")
    w = work[0]
    conf = [c for c in bench["configs"] if c["name"] == w["config"]]
    if not conf:
        raise KeyError(f"cell {name!r}: no configuration named {w['config']!r}")
    config = load_json(ROOT / conf[0]["file"], f"configuration {w['config']!r}")
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if name in m.get("workloads", [name] if m["moves"] in reported else [])]
    return Cell(name, w["chips"], config, traffic(w["traffic"]), path(config["path"]),
                e2e, per_layer)
