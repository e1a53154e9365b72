"""The window's arithmetic on synthetic timings."""

import pytest

from benchmark.harness import window


def test_rate_over_the_whole_window():
    # three dispatches of 128 TTIs with gaps between them: the rate is over
    # the first start to the last end, gaps included
    starts, ends = [10.0, 10.5, 11.5], [10.2, 10.7, 12.0]
    m = window.end_to_end(starts, ends, 128, 3_000_000_000, t0=1.0)
    assert m["tti_per_s"] == pytest.approx(3 * 128 / 2.0)
    assert m["setup_s"] == pytest.approx(9.0)
    assert m["peak_device_mb"] == pytest.approx(3000.0)


def test_p95_over_all_dispatches():
    # 100 dispatches of 1..100 ms: the 95th by nearest rank is the 95th value
    starts = [float(i) for i in range(100)]
    ends = [s + (i + 1) * 1e-3 for i, s in enumerate(starts)]
    m = window.end_to_end(starts, ends, 128, 0, t0=0.0)
    assert m["dispatch_p95_ms"] == pytest.approx(95.0)


@pytest.mark.parametrize("values, p95", [([7.0], 7.0), ([1.0, 2.0], 2.0),
                                         (list(range(1, 21)), 19), (list(range(20, 0, -1)), 19)])
def test_p95_nearest_rank(values, p95):
    assert window.p95(values) == p95


def test_an_empty_window_is_refused():
    with pytest.raises(ValueError):
        window.end_to_end([], [], 128, 0, 0.0)
