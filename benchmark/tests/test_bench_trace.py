"""The traced stretch read back from a Chrome trace: device time by the
host range that launched it, the busy share, and the idle gaps."""
import pytest

from benchmark import trace


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "pid": 0, "tid": tid}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _events():
    """Two calls in a 1,000 us stretch. Each: stage 1 launches K1 (100 us
    on the card), stage 2 a gather (50 us); then host assembly, with the
    card idle."""
    ev = [_x("user_annotation", trace.STRETCH, 0, 1000)]
    for i, t in enumerate((0, 500)):
        ev += [_x("user_annotation", trace.CALL, t, 450),
               _x("user_annotation", "store.knn", t + 10, 300),
               _x("user_annotation", "fused_scan.stage1", t + 20, 30),
               _x("cuda_runtime", "cudaLaunchKernel", t + 25, 5,
                  corr=10 + i),
               _x("kernel", "k1", t + 40, 100, tid=7, corr=10 + i),
               _x("user_annotation", "fused_scan.stage2", t + 60, 40),
               _x("cuda_runtime", "cudaLaunchKernel", t + 65, 5,
                  corr=20 + i),
               _x("kernel", "gather", t + 140, 50, tid=7, corr=20 + i),
               _x("user_annotation", "flat.assemble", t + 320, 120),
               _x("cpu_op", "aten::copy_", t + 300, 10)]
    # A kernel whose launch the trace lost, and events outside the stretch.
    ev += [_x("kernel", "orphan", 900, 10, tid=7, corr=99),
           _x("kernel", "late", 2000, 50, tid=7, corr=10),
           {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5}]
    return ev


def test_device_time_is_tied_to_the_ranges_that_launched_it():
    tl = trace.read(_events(), calls=2)
    assert tl.calls == 2
    assert tl.window_s == pytest.approx(1000e-6)
    assert tl.device_s["fused_scan.stage1"] == pytest.approx(200e-6)
    assert tl.device_s["fused_scan.stage2"] == pytest.approx(100e-6)
    assert tl.device_s["store.knn"] == pytest.approx(300e-6)
    assert "flat.assemble" not in tl.device_s
    assert tl.unattributed == 1
    assert tl.ops_s == pytest.approx({"k1": 200e-6, "gather": 100e-6,
                                      "orphan": 10e-6})


def test_busy_is_the_union_of_device_intervals_in_the_stretch():
    tl = trace.read(_events(), calls=2)
    assert tl.busy_s == pytest.approx(310e-6)      # 2 x (100 + 50) + 10
    idle = sum(tl.idle_s.values())
    assert idle == pytest.approx(690e-6)
    # Each stretch of a gap goes to the innermost range open meanwhile.
    assert tl.idle_s == pytest.approx({
        "benchmark.stretch": 100e-6, "benchmark.call": 60e-6,
        "store.knn": 260e-6, "fused_scan.stage1": 40e-6,
        "flat.assemble": 230e-6})
    assert tl.longest_gaps[0][0] == max(s for s, _, _ in tl.longest_gaps)


def test_a_trace_without_the_stretch_is_refused():
    with pytest.raises(ValueError):
        trace.read([_x("kernel", "k", 0, 1, corr=1)], calls=0)


def test_profiled_calls_stop_at_the_count():
    made = []
    run_calls = trace.profiled_calls(lambda: made.append(1), 5, 60.0)
    import contextlib
    assert run_calls(contextlib.nullcontext) == 5 and len(made) == 5
