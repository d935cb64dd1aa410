"""The per-layer metrics read from the program's host spans inside
``nn_many`` (``benchmark/spans.py``), and idle time under nested ranges."""
import pytest

from benchmark import registry, run, trace
from benchmark.tests.conftest import tiny_cell
from benchmark.tests.test_bench_trace import _x

#: Each span-reading metric and the program span it reads.
SPAN_METRICS = {
    "query_stack_ms": "flat.stack",
    "store_upload_ms": "store.upload",
    "store_wait_ms": "store.copy_back",
    "row2uid_ms": "store.row2uid",
    "results_fetch_ms": "results.fetch",
    "results_regroup_ms": "results.regroup",
}


def _run(counters):
    return run.Run(config={}, traffic={}, seconds=1.0, counters=counters)


@pytest.mark.parametrize("metric,span", sorted(SPAN_METRICS.items()))
def test_a_span_metric_is_its_spans_ms_a_call(metric, span):
    reader = registry.load_module("metrics", metric)
    got = reader.read(_run({f"span.{span}.calls": 4.0,
                            f"span.{span}.seconds": 0.010,
                            "span.other.calls": 1.0,
                            "span.other.seconds": 9.0}))
    assert got == pytest.approx(2.5)


@pytest.mark.parametrize("metric", sorted(SPAN_METRICS))
def test_a_span_metric_reads_nothing_without_its_span(metric):
    reader = registry.load_module("metrics", metric)
    assert reader.read(_run({})) is None
    assert reader.read(_run({"span.flat.assemble.calls": 3.0,
                             "span.flat.assemble.seconds": 0.3})) is None


def test_every_span_metric_is_declared_for_the_flat_cells():
    spec = registry.load_spec()
    declared = {m["name"]: m for m in spec["per_layer"]}
    for name in SPAN_METRICS:
        m = declared[name]
        assert m["source"] == "program_span" and m["moves"] == "qps"
        assert m["workloads"] == [w["name"] for w in spec["workloads"]]


def test_a_traced_run_reports_every_span_metric():
    """A traced run on the CPU reads each span metric from the program.
    The children take at most their parents' host time; the assembly's
    tile it. (On the CPU the stages run inside ``store.knn``'s own time,
    so its children need not hold most of it there.)"""
    cell, config, traffic, metrics = tiny_cell(trace=True)
    res = run.run_cell(cell, config, traffic, metrics, 2 ** 31 + 5, 0.3,
                       True, device="cpu")
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(SPAN_METRICS) <= set(got)
    store = got["store_upload_ms"] + got["store_wait_ms"] \
        + got["row2uid_ms"]
    assemble = got["results_fetch_ms"] + got["results_regroup_ms"]
    assert 0 < store <= got["store_knn_ms"]
    assert 0.5 * got["assemble_ms"] < assemble <= got["assemble_ms"]


def test_idle_time_under_a_child_range_goes_to_the_child():
    """A gap inside ``store.upload`` (inside ``store.knn``) is the
    child's; the parent keeps only the idle time outside its children."""
    ev = [_x("user_annotation", trace.STRETCH, 0, 1000),
          _x("user_annotation", "store.knn", 100, 600),
          _x("user_annotation", "store.upload", 150, 100),
          _x("cuda_runtime", "cudaLaunchKernel", 300, 5, corr=1),
          _x("kernel", "k1", 310, 300, tid=7, corr=1),
          _x("user_annotation", "store.copy_back", 320, 330),
          _x("user_annotation", "store.row2uid", 660, 30)]
    tl = trace.read(ev, calls=1)
    assert tl.idle_s == pytest.approx({
        "benchmark.stretch": 400e-6, "store.knn": 130e-6,
        "store.upload": 100e-6, "store.copy_back": 40e-6,
        "store.row2uid": 30e-6})
    assert tl.device_s == pytest.approx({"benchmark.stretch": 300e-6,
                                         "store.knn": 300e-6})
