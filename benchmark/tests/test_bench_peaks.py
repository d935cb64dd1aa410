"""The roofline arithmetic of the per-layer metrics."""
from types import SimpleNamespace

import pytest

from benchmark import peaks, registry
from benchmark.trace import Timeline


def test_bound_takes_the_larger_of_operations_and_bytes():
    t, by = peaks.bound_s(989e12, 3.35e12 / 2)
    assert (t, by) == (pytest.approx(1.0), "flops")
    t, by = peaks.bound_s(989e12 / 4, 3.35e12)
    assert (t, by) == (pytest.approx(1.0), "bytes")


@pytest.mark.parametrize("b,n,d,ms,by", [
    # GIST1M, B = 1,024: 2 B N d = 1.966e12 operations.
    (1024, 1_000_000, 960, 1.98794742, "flops"),
    # Deep10M, B = 1,024: the same operations, 4.16e9 bytes.
    (1024, 10_000_000, 96, 1.98794742, "flops"),
    # GIST1M, B = 16: the rows once, 3.84 GB at 3.35 TB/s.
    (16, 1_000_000, 960, 1.14643625, "bytes"),
])
def test_flat_stage1_bound_counts_the_live_work_once(b, n, d, ms, by):
    t, got = peaks.flat_stage1(b, n, d)
    assert got == by
    assert 1e3 * t == pytest.approx(ms, rel=1e-6)
    nbytes = 4.0 * (n * d + b * d + b * n / 128)
    assert t == pytest.approx(max(2.0 * b * n * d / 989e12,
                                  nbytes / 3.35e12))


def test_flat_stage1_bound_does_not_count_padding():
    # The store pads 10M rows to 2^24 and 960 dims to 1,024: neither is
    # work the inputs need.
    assert peaks.flat_stage1(1024, 10_000_000, 96) \
        < peaks.flat_stage1(1024, 1 << 24, 128)


def _traced(stage1_s, calls):
    tl = Timeline(calls=calls, window_s=1.0, busy_s=0.5,
                  device_s={"fused_scan.stage1": stage1_s,
                            "fused_scan.stage2": 0.25})
    return SimpleNamespace(timeline=tl, traffic={"batch": 16},
                           config={"data": {"n": 1_000_000, "dim": 960}})


def test_stage1_roofline_is_the_bound_over_the_device_time_a_call():
    read = registry.load_module("metrics", "stage1_roofline").read
    bound, _ = peaks.flat_stage1(16, 1_000_000, 960)
    # 10 calls of 4 x the bound each: 25%.
    assert read(_traced(10 * 4 * bound, 10)) == pytest.approx(25.0)


def test_device_metrics_read_nothing_without_a_trace():
    for name in ("stage1_roofline", "stage2_device_ms", "device_idle_pct"):
        read = registry.load_module("metrics", name).read
        assert read(SimpleNamespace(timeline=None)) is None
    # A trace with no stage-1 range gives no share, never 0.
    assert registry.load_module("metrics", "stage1_roofline").read(
        _traced(0.0, 10)) is None


def test_stage2_and_idle_from_the_timeline():
    run = _traced(0.1, 10)
    assert registry.load_module("metrics", "stage2_device_ms").read(
        run) == pytest.approx(25.0)
    assert registry.load_module("metrics", "device_idle_pct").read(
        run) == pytest.approx(50.0)
