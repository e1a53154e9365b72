"""One run of a cell: set-up, the window (or, traced, a fixed stretch),
then the check against the reference.

Set-up builds the kernels (only the first run in a checkout compiles),
the program's and the reference's deployments, the stimulus pool on the
device, and warms up: the first dispatch captures every CUDA graph the
cell's shapes need.  The window is closed-loop, one dispatch in flight:
the pool's batches in turn, each dispatch from its start to the outputs
the MAC needs on the host.  Every dispatch's TBs are scored against the
bits sent, and its outputs against those of the first dispatch of the same
pool batch, on the device.  After the window the timed path also receives
the mix's `edge_batches` (at `edge_snr_db`, where many transport blocks sit
at the turbo decoder's threshold), and its outputs on those and on the
first dispatch of each of `check_batches` pool batches, drawn from the
seed, are compared with the reference's receive of the same batches.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from collections import Counter
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.harness import cells, check, deploy, imports, trace as trace_mod, window
from benchmark.reference import stimulus

clock = time.perf_counter
CONTROLS = ("prog_bf16", "ref_bf16")


class ForbiddenModules(RuntimeError):
    pass


def _span_of(on: bool):
    def span(name):
        if on:
            return torch.profiler.record_function(trace_mod.PREFIX + name)
        return contextlib.nullcontext()
    return span


class Readback:
    """Copies a dispatch's outputs to the host: on the card into pinned
    buffers kept from one dispatch to the next, then one synchronise."""

    def __init__(self, pinned: bool):
        self.pinned, self.buf = pinned, {}

    def __call__(self, out: dict, keys) -> dict:
        for k in keys:
            t, b = out[k], self.buf.get(k)
            if b is None or b.shape != t.shape or b.dtype != t.dtype:
                b = self.buf[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=self.pinned)
            b.copy_(t, non_blocking=self.pinned)
        if self.pinned:
            torch.cuda.current_stream().synchronize()
        return self.buf


def _siso_counts():
    """(SISO launches of both dtypes, launches by shape) so far, the
    conditional bodies' included."""
    from srslte_tpu_torch.ops import tdec_cuda
    from srslte_tpu_torch.utils import jit

    jit.fold_launches()
    s = tdec_cuda.siso_windowed
    return s.launches + s.launches_bf16, Counter(s.shapes)


def _check_modules(when: str):
    bad = imports.forbidden_loaded()
    if bad:
        raise ForbiddenModules(f"{when}, the process holds the modules {bad}")


def _aggregate(numbers: dict, batch_numbers: dict):
    for k, v in batch_numbers.items():
        numbers[k] = max(numbers.get(k, 0.0), v) if k.endswith("_err") else numbers.get(k, 0) + v


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def run(cell: cells.Cell, seed: int, seconds: float, trace: bool = False,
        device: str = "cuda", control: str | None = None, t0: float | None = None) -> dict:
    """The result of one run (the dict the last line prints)."""
    t0 = clock() if t0 is None else t0
    _check_modules("at start")
    if control not in (None,) + CONTROLS:
        raise ValueError(f"unknown control {control!r}")
    config, traffic, path = cell.config, cell.traffic, cell.path
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        from srslte_tpu_torch.ops import _build

        _build.build_all()
    siso = {"float32": torch.float32}[config["precision"]]
    if control == "prog_bf16":  # the program's own 16-bit SISO path
        siso = torch.bfloat16
    prog = deploy.build(config, deploy.PROGRAM, dev)
    ref = deploy.build(config, deploy.REFERENCE, dev)
    pool = stimulus.make_pool(ref, traffic, seed, dev)
    n_pool, batch = pool.batches, traffic["batch"]
    readback = Readback(cuda)
    quiet = _span_of(False)

    def dispatch(p: int, span):
        t_start = clock()
        with span("dispatch"):
            out = path.receive(prog, pool.rx[p], span, siso_dtype=siso)
            t_issue = clock()
            with span("readback"):
                readback(out, path.OUTPUTS)
        return out, (t_start, t_issue, clock())

    for d in range(traffic["warmup_dispatches"]):
        dispatch(d % n_pool, quiet)
    if cuda:
        torch.cuda.synchronize()

    kept = [None] * n_pool
    failed = torch.zeros((), dtype=torch.int64, device=dev)
    differ = torch.zeros((), dtype=torch.int64, device=dev)
    times = []
    span = _span_of(trace)

    def one(d: int):
        nonlocal failed, differ
        p = d % n_pool
        out, t = dispatch(p, span)
        times.append(t)
        with span("score"):
            failed = failed + path.failed(prog, out, pool, p)
            if kept[p] is None:
                kept[p] = out
            else:
                differ = differ + check.outputs_differ(out, kept[p], path.OUTPUTS)

    tr, counts = None, (0, Counter())
    if not trace:
        d = 0
        while not times or times[-1][2] - times[0][0] < seconds:
            one(d)
            d += 1
    else:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
            before = _siso_counts()
        with torch.profiler.profile(activities=acts) as prof:
            for d in range(traffic["trace_dispatches"]):
                one(d)
            if cuda:
                torch.cuda.synchronize()
        if cuda:
            after = _siso_counts()
            counts = (after[0] - before[0], after[1] - before[1])
        with tempfile.TemporaryDirectory() as tmp:
            f = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(f)
            tr = trace_mod.Trace.load(f)
    if cuda:
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_reserved(dev) if cuda else 0
    n_failed, n_differ = int(failed), int(differ)
    attempted = path.transport_blocks(prog, batch) * len(times)
    _check_modules("once the window closed")

    # the check, after the window: the timed path on the edge batches, then
    # the reference on the pool batches drawn from the seed and on those
    t_check = clock()
    edge = stimulus.make_edge(ref, traffic, seed, dev)
    edge_out = [path.receive(prog, edge.rx[e], siso_dtype=siso) for e in range(edge.batches)]
    del prog
    rng = np.random.default_rng(seed)
    seen = [p for p in range(n_pool) if kept[p] is not None]
    checked = sorted(rng.choice(seen, size=min(traffic["check_batches"], len(seen)),
                                replace=False).tolist())
    jobs = [(pool, p, kept[p]) for p in checked] + [(edge, e, o) for e, o in enumerate(edge_out)]
    numbers = {}
    for src, i, out in jobs:
        want = path.receive(ref, src.rx[i])
        got = path.receive(ref, src.rx[i], lowp=True) if control == "ref_bf16" else out
        _aggregate(numbers, path.compare(got, want, src, i))
        del want, got
    del edge_out, jobs
    numbers["replay_diff"] = n_differ
    log(f"check: {len(checked)} of {n_pool} pool batches and {edge.batches} edge batches "
        f"at {traffic['edge_snr_db']} dB against the reference in {clock() - t_check:.1f} s; "
        f"window of {len(times)} dispatches")
    limits = path.LIMITS
    correct = all(numbers[k] <= limits[k] for k in limits)

    if trace:
        ctx = SimpleNamespace(ttis=batch * len(times), dispatches=times, trace=tr,
                              siso_launches=counts[0], siso_shapes=counts[1])
        values = {m["name"]: cells.reader(m["name"])(ctx) for m in cell.per_layer}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.per_layer if values[m["name"]] is not None}
    else:
        values = window.end_to_end([t[0] for t in times], [t[2] for t in times], batch,
                                   peak, t0)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev_info = {"platform": "gpu" if cuda else dev.type,
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted, "failed": n_failed,
              "metrics": metrics, "device": dev_info}
    if trace:
        dev_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        result["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    _check_modules("once the check and the readers ran")
    return result


def describe(result: dict) -> list:
    """The compared numbers as lines: name, number, limit."""
    return [f"check {k} {v['value']!r} limit {v['limit']!r}"
            + ("" if v["value"] <= v["limit"] else " FAILED")
            for k, v in result["check"].items()]


