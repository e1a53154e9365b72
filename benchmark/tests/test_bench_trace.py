"""The trace's reduction and the roofline arithmetic on synthetic traces."""

from collections import Counter
from types import SimpleNamespace

import pytest

from benchmark.harness import roofline, trace
from benchmark.harness.cells import reader


def _span(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": "bench." + name, "ts": ts, "dur": dur}


def _launch(name, ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _op(name, ts, dur, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr}}


def synthetic():
    """Two dispatches [0, 100] and [120, 200] us.  The first replays a
    graph in its front end (two kernels that overlap) and launches a SISO
    in its data span; the second launches a copy in its readback."""
    return [
        _span("dispatch", 0, 100), _span("front_end", 0, 20), _span("data", 20, 70),
        _span("readback", 70, 30), _span("dispatch", 120, 80), _span("readback", 150, 50),
        _launch("cudaGraphLaunch", 5, 1), _launch("cudaLaunchKernel", 25, 2),
        _launch("cudaMemcpyAsync", 155, 3),
        _op("fft_kernel", 10, 20, 1), _op("chest_kernel", 25, 15, 1),  # union [10, 40]
        _op("siso_kernel<float>", 50, 30, 2),  # [50, 80]
        _op("Memcpy DtoH", 160, 20, 3, cat="gpu_memcpy"),  # [160, 180]
        _op("outside", 300, 10, 2),  # after the window: clipped away
    ]


def test_device_time_belongs_to_the_span_of_its_launch():
    t = trace.Trace(synthetic())
    assert t.window == (0, 200)
    assert t.graph_ops() == 2
    assert t.span_device_s("front_end") == pytest.approx(35e-6)  # both graph kernels
    assert t.span_device_s("data") == pytest.approx(30e-6)
    assert t.span_device_s("readback") == pytest.approx(20e-6)


def test_idle_share_is_the_union_of_intervals():
    t = trace.Trace(synthetic())
    # busy: [10, 40] + [50, 80] + [160, 180] = 80 us of 200, overlap counted once
    assert t.busy_s() == pytest.approx(80e-6)
    ctx = SimpleNamespace(trace=t)
    assert reader("device_idle_pct")(ctx) == pytest.approx(60.0)


def test_idle_gaps_name_the_host_span_and_top_ops():
    t = trace.Trace(synthetic())
    gaps = t.idle_gaps()
    # [80, 160] starts in the first dispatch's readback; [180, 200] in the
    # second's; [0, 10] in the front end; [40, 50] in the data span
    assert gaps[0] == ["readback", pytest.approx(80e-6)]
    assert [g[0] for g in gaps] == ["readback", "readback", "front_end", "data"]
    assert t.top_ops()[0] == ["siso_kernel<float>", pytest.approx(30e-6)]


def test_layer_readers_per_tti_and_nothing_without_graph_kernels():
    t = trace.Trace(synthetic())
    ctx = SimpleNamespace(trace=t, ttis=256, siso_launches=1, dispatches=[(0, 1, 2), (3, 5, 6)],
                          siso_shapes=Counter({("siso_windowed", "B=1408 K=5824 L=256 T=32"): 1}))
    assert reader("front_end_us_per_tti")(ctx) == pytest.approx(35.0 / 256)
    assert reader("data_us_per_tti")(ctx) == pytest.approx(30.0 / 256)
    assert reader("host_issue_ms")(ctx) == pytest.approx(1500.0)
    assert reader("siso_launches_per_tti")(ctx) == pytest.approx(1 / 256)
    no_graph = trace.Trace([e for e in synthetic() if e.get("args", {}).get("correlation") != 1
                            or e["cat"] == "cuda_runtime"])
    ctx.trace = no_graph
    for name in ("front_end_us_per_tti", "control_us_per_tti", "data_us_per_tti",
                 "device_idle_pct"):
        assert reader(name)(ctx) is None


def test_siso_bytes_and_roofline():
    # the DL path's shape: 3 [B, K] float32 tensors and the tail's beta
    assert roofline.siso_bytes(1408, 5824, 4) == (3 * 1408 * 5824 + 8 * 1408) * 4
    shapes = Counter({("siso_windowed", "B=1408 K=5824 L=256 T=32"): 2,
                      ("siso_windowed_bf16", "B=64 K=512 L=128 T=32"): 1})
    least = (2 * roofline.siso_bytes(1408, 5824, 4) + roofline.siso_bytes(64, 512, 2)) / 3.35e12
    assert roofline.siso_least_s(shapes) == pytest.approx(least)
    # the share: least time over the SISO kernels' time in the trace
    t = trace.Trace(synthetic())
    ctx = SimpleNamespace(trace=t, siso_launches=1, siso_shapes=Counter(
        {("siso_windowed", "B=8 K=512 L=128 T=32"): 1}))
    want = 100 * roofline.siso_bytes(8, 512, 4) / 3.35e12 / 30e-6
    assert reader("siso_roofline")(ctx) == pytest.approx(want)
    ctx.siso_launches = 2  # the trace holds one launch of two counted: nothing to read
    assert reader("siso_roofline")(ctx) is None


def test_merge():
    assert trace.merge([(5, 6), (0, 2), (1, 3), (3, 4)]) == [[0, 4], [5, 6]]
