"""
The JAX flat index's contract suite (``tests/impls/nn_index/test_flat.py``),
run against the port's ``FlatNearestNeighborsIndex`` on the CPU: geometry,
metrics, mutation, persistence and bf16 storage. It also covers the store's
capacity growth and compaction, concurrent queries during mutation, and
the query path's tracing spans and profiler ranges.
"""
import json
import random
import threading

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorMemoryElement, stack_vectors,
)
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.ops.store import VectorStore

torch.set_num_threads(1)


def _index(**kw):
    return FlatNearestNeighborsIndex(device="cpu", **kw)


def _mk(i, vec):
    return DescriptorMemoryElement(i, np.asarray(vec, dtype=np.float32))


def _small_index():
    descrs = [_mk(i, [float(i), float(i)]) for i in range(10)]
    idx = _index()
    idx.build_index(descrs)
    return idx, descrs


def test_stack_vectors_equals_vstack():
    """The builds' one-pass stacking gives ``np.vstack(...).astype(
    np.float32)`` bit for bit, float64 and integer vectors included, and
    refuses vectors of unequal length as ``np.vstack`` does."""
    rng = np.random.default_rng(3)
    vecs = [rng.normal(size=7), rng.normal(size=7).astype(np.float32),
            rng.integers(-5, 5, size=7)]
    elems = [DescriptorMemoryElement(i, v) for i, v in enumerate(vecs)]
    got = stack_vectors(elems)
    assert got.dtype == np.float32 and got.shape == (3, 7)
    assert np.array_equal(got, np.vstack(vecs).astype(np.float32))
    with pytest.raises(ValueError):
        stack_vectors(elems + [DescriptorMemoryElement(9, np.ones(8))])


def test_query_is_own_nearest_neighbor():
    rng = np.random.default_rng(0)
    descrs = [_mk(i, rng.normal(size=64)) for i in range(200)]
    idx = _index()
    idx.build_index(descrs)
    assert idx.count() == 200
    for q in random.Random(1).sample(descrs, 10):
        ns, ds = idx.nn(q, 3)
        assert ns[0].uuid() == q.uuid()
        assert ds[0] == 0.0
        assert list(ds) == sorted(ds)


def test_perturbed_query_retrieves_source():
    rng = np.random.default_rng(2)
    descrs = [_mk(i, rng.normal(size=32)) for i in range(500)]
    idx = _index()
    idx.build_index(descrs)
    q = _mk("q", descrs[123].vector() + 0.001 * rng.normal(size=32))
    ns, _ = idx.nn(q, 1)
    assert ns[0].uuid() == 123


def test_colinear_points_exact_order():
    descrs = [_mk(j, [j + 1.0, 2.0 * (j + 1.0)]) for j in range(50)]
    idx = _index()
    idx.build_index(descrs)
    ns, ds = idx.nn(_mk("q", [0.0, 0.0]), 10)
    assert [n.uuid() for n in ns] == list(range(10))
    assert list(ds) == sorted(ds)


def test_unit_vectors_all_equidistant():
    dim = 8
    idx = _index()
    idx.build_index([_mk(i, np.eye(dim)[i]) for i in range(dim)])
    ns, ds = idx.nn(_mk("q", np.eye(dim)[0]), dim)
    assert ds[0] == 0.0
    np.testing.assert_allclose(ds[1:], np.sqrt(2.0), rtol=1e-6)


def test_nn_many_matches_single():
    rng = np.random.default_rng(3)
    descrs = [_mk(i, rng.normal(size=16)) for i in range(100)]
    idx = _index()
    idx.build_index(descrs)
    batch = idx.nn_many(descrs[:7], 4)
    for q, (ns_b, ds_b) in zip(descrs[:7], batch):
        ns_s, ds_s = idx.nn(q, 4)
        assert [n.uuid() for n in ns_b] == [n.uuid() for n in ns_s]
        np.testing.assert_allclose(ds_b, ds_s, rtol=1e-6)


@pytest.mark.parametrize("metric, vectors, query, order, dists", [
    ("cosine", {"a": [1.0, 0.0], "b": [1.0, 1.0], "c": [0.0, 1.0]},
     [2.0, 0.0], ["a", "b", "c"], [0.0, 0.5, 1.0]),
    ("hik", {"a": [0.5, 0.5, 0.0], "b": [0.0, 0.5, 0.5]},
     [0.5, 0.5, 0.0], ["a", "b"], [0.0, 0.5]),
    ("inner_product", {"lo": [1.0, 0.0], "hi": [10.0, 0.0]},
     [1.0, 0.0], ["hi", "lo"], [-10.0, -1.0]),
    ("chi_square", {"a": [0.5, 0.5, 0.0], "b": [0.0, 0.5, 0.5]},
     [0.5, 0.5, 0.0], ["a", "b"], [0.0, 1.0]),
])
def test_metric_geometry(metric, vectors, query, order, dists):
    idx = _index(metric=metric)
    idx.build_index([_mk(u, v) for u, v in vectors.items()])
    ns, ds = idx.nn(_mk("q", query), len(vectors))
    assert [n.uuid() for n in ns] == order
    np.testing.assert_allclose(ds, dists, atol=1e-3)


def test_rebuild_replaces():
    idx, _ = _small_index()
    idx.build_index([_mk("only", [5.0, 5.0])])
    assert idx.count() == 1
    ns, _ = idx.nn(_mk("q", [0.0, 0.0]), 1)
    assert ns[0].uuid() == "only"


def test_update_adds_and_update_on_empty_builds():
    idx, _ = _small_index()
    idx.update_index([_mk(100, [100.0, 100.0])])
    assert idx.count() == 11
    ns, _ = idx.nn(_mk("q", [101.0, 101.0]), 1)
    assert ns[0].uuid() == 100
    empty = _index()
    empty.update_index([_mk(0, [1.0, 2.0])])
    assert empty.count() == 1


def test_update_duplicate_uid_skipped_with_warning():
    idx, _ = _small_index()
    with pytest.warns(UserWarning, match="already-indexed"):
        idx.update_index([_mk(0, [99.0, 99.0])])
    assert idx.count() == 10
    ns, ds = idx.nn(_mk("q", [0.0, 0.0]), 1)
    assert ns[0].uuid() == 0 and ds[0] == 0.0


def test_remove_and_re_add():
    idx, descrs = _small_index()
    idx.remove_from_index([0, 1])
    assert idx.count() == 8
    ns, _ = idx.nn(_mk("q", [0.0, 0.0]), 1)
    assert ns[0].uuid() == 2
    idx.update_index([descrs[0]])
    ns, _ = idx.nn(descrs[0], 1)
    assert ns[0].uuid() == 0


def test_remove_duplicate_uids_no_corruption():
    idx, _ = _small_index()
    idx.remove_from_index([5, 5])
    assert idx.count() == 9
    ns, _ = idx.nn(_mk("q", [5.0, 5.0]), 2)
    assert {n.uuid() for n in ns} == {4, 6}


def test_remove_all_then_query_raises():
    idx, _ = _small_index()
    idx.remove_from_index(range(10))
    assert idx.count() == 0
    with pytest.raises(ValueError):
        idx.nn(_mk("q", [0.0, 0.0]))


def test_save_load_roundtrip_through_update_and_remove():
    elem = DataMemoryElement()
    idx = _index(index_element=elem)
    idx.build_index([_mk(i, [float(i), 1.0]) for i in range(5)])
    idx.update_index([_mk(10, [10.0, 1.0])])
    idx.remove_from_index([0])
    idx2 = _index(index_element=elem)
    assert idx2.count() == 5
    ns, _ = idx2.nn(_mk("q", [10.0, 1.0]), 1)
    assert ns[0].uuid() == 10
    with pytest.raises(KeyError):
        idx2.remove_from_index([0])


def test_read_only_index_element_raises_on_build():
    idx = _index(index_element=DataMemoryElement(readonly=True))
    with pytest.raises(ReadOnlyError):
        idx.build_index([_mk(0, [1.0])])


def test_bf16_self_retrieval_and_order():
    rng = np.random.default_rng(4)
    descrs = [_mk(i, rng.normal(size=48)) for i in range(300)]
    idx = _index(dtype="bfloat16")
    idx.build_index(descrs)
    for q in descrs[:20]:
        ns, ds = idx.nn(q, 5)
        assert ns[0].uuid() == q.uuid()
        assert list(ds) == sorted(ds)


def test_cosine_mirror_follows_mutation():
    # The cosine stage-1 mirror must be rebuilt after an in-place append:
    # with 24 segments and 16 kept, a stale (zero) mirror row would leave
    # the new row's segment unselected.
    rng = np.random.default_rng(7)
    idx = _index(metric="cosine")
    idx.build_index([_mk(i, rng.normal(size=8)) for i in range(3000)])
    idx.nn(_mk("q", rng.normal(size=8)), 1)          # builds the mirror
    x = rng.normal(size=8)
    idx.update_index([_mk("x", x)])
    ns, ds = idx.nn(_mk("q", 3.0 * x), 1)
    assert ns[0].uuid() == "x"
    assert ds[0] < 1e-3


def test_store_capacity_growth_and_compaction_stay_exact():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(3000, 24)).astype(np.float32)
    q = rng.normal(size=(6, 24)).astype(np.float32)
    store = VectorStore(device="cpu")
    store.build(x[:900], list(range(900)))
    assert store.capacity == 1024
    store.add(x[900:], list(range(900, 3000)))     # grows to 4096 rows
    assert store.capacity == 4096
    gone = list(range(0, 2000))
    store.remove(gone)                               # compacts: 1000 live
    assert store.n_valid == 1000 and store.capacity == 1024
    d, uids, _ = store.knn(q, 5)
    d2 = ((q[:, None, :].astype(np.float64) - x[None, 2000:]) ** 2).sum(-1)
    order = np.argsort(d2, axis=1)[:, :5]
    assert [list(u) for u in uids] == (order + 2000).tolist()
    np.testing.assert_allclose(d, np.sqrt(np.take_along_axis(d2, order, 1)),
                               rtol=1e-5)


def test_concurrent_queries_during_mutation():
    rng = np.random.default_rng(6)
    descrs = [_mk(i, rng.normal(size=16)) for i in range(400)]
    idx = _index()
    idx.build_index(descrs[:200])
    errors = []

    def query():
        try:
            for _ in range(20):
                for ns, ds in idx.nn_many(descrs[:8], 3):
                    assert len(ns) == 3 and list(ds) == sorted(ds)
        except Exception as e:  # surfaced to the main thread below
            errors.append(e)

    threads = [threading.Thread(target=query) for _ in range(4)]
    for t in threads:
        t.start()
    for i in range(200, 400, 20):
        idx.update_index(descrs[i:i + 20])
        idx.remove_from_index([i])
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    assert errors == []
    assert idx.count() == 390


def _annotations(log_dir):
    """The profiler ranges of ``<log_dir>/trace.json``: (name, start,
    end, thread), in microseconds."""
    with open(log_dir / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]),
             e.get("tid")) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def _inside(child, parent) -> bool:
    return (child[3] == parent[3] and parent[1] <= child[1]
            and child[2] <= parent[2])


def test_query_spans_and_profiler_trace(tmp_path):
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS, trace
    idx, descrs = _small_index()
    spans = ("flat.query", "store.knn", "flat.assemble")
    before = COUNTERS.snapshot()
    with trace(str(tmp_path)):
        idx.nn_many(descrs[:3], 2)
    after = COUNTERS.snapshot()

    def delta(key):
        return after.get(key, 0.0) - before.get(key, 0.0)

    for s in spans:
        assert delta(f"span.{s}.calls") == 1, s
    # The stages are device ranges: in the trace, with no counter.
    names = {a[0] for a in _annotations(tmp_path)}
    for r in ("fused_scan.stage1", "fused_scan.stage2"):
        assert r in names and f"span.{r}.calls" not in after, r
    # The query span encloses the store's and the assembly's.
    assert delta("span.flat.query.seconds") \
        >= delta("span.store.knn.seconds") \
        + delta("span.flat.assemble.seconds") > 0
    assert (tmp_path / "trace.json").stat().st_size > 0


#: Each span and range of a flat query with the one it lies in.
QUERY_NESTING = {
    "flat.stack": "nn_many", "flat.query": "nn_many",
    "store.knn": "flat.query", "flat.assemble": "flat.query",
    "store.upload": "store.knn", "fused_scan.prep": "store.knn",
    "fused_scan.stage1": "store.knn",
    "fused_scan.stage2": "store.knn", "store.copy_back": "store.knn",
    "store.row2uid": "store.knn", "fused_scan.select": "fused_scan.stage1",
    "fused_scan.gather": "fused_scan.stage2",
    "fused_scan.exact": "fused_scan.stage2",
    "fused_scan.topk": "fused_scan.stage2",
    "results.fetch": "flat.assemble", "results.regroup": "flat.assemble",
}
HOST_SPANS = ("nn_many", "flat.stack", "flat.query", "store.knn",
              "store.upload", "store.copy_back", "store.row2uid",
              "flat.assemble", "results.fetch", "results.regroup")


def test_query_trace_nests_every_span_and_range(tmp_path):
    """One ``nn_many`` under a profiler: every host span and device range
    of the query path in the trace, each inside its parent; each host
    span's call counter rises by one."""
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS, trace
    idx, descrs = _small_index()
    before = COUNTERS.snapshot()
    with trace(str(tmp_path)):
        idx.nn_many(descrs[:3], 2)
    after = COUNTERS.snapshot()
    ann = _annotations(tmp_path)
    by_name = {}
    for a in ann:
        by_name.setdefault(a[0], []).append(a)
    assert set(QUERY_NESTING) | {"nn_many"} <= set(by_name)
    for child, parent in QUERY_NESTING.items():
        for c in by_name[child]:
            assert any(_inside(c, p) for p in by_name[parent]), child
    for name in HOST_SPANS:
        key = f"span.{name}.calls"
        assert after.get(key, 0.0) - before.get(key, 0.0) == 1, name


def test_bf16_stage2_opens_the_same_ranges(tmp_path):
    """``rerank_segments_bf16`` puts its steps under the f32 stage 2's
    range names."""
    from smqtk_indexing_tpu_torch.ops import fused_scan
    from smqtk_indexing_tpu_torch.utils.tracing import trace
    rng = np.random.default_rng(8)
    n, d, b = 2048, 16, 8
    db = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))
    valid = torch.ones(n, dtype=torch.bool)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    with trace(str(tmp_path)):
        fused_scan.flat_topk_fused(
            db, (db * db).sum(1), valid, q, k=4, precision="highest",
            db_seg_lo=db.to(torch.bfloat16).view(n // 128, 128, d))
    ann = _annotations(tmp_path)
    stage2 = [a for a in ann if a[0] == "fused_scan.stage2"]
    for name in ("fused_scan.gather", "fused_scan.exact", "fused_scan.topk"):
        found = [a for a in ann if a[0] == name]
        assert found and all(any(_inside(c, p) for p in stage2)
                             for c in found), name


def test_spans_open_a_profiler_range_only_under_a_profiler(monkeypatch):
    """With no profiler running, ``trace_span`` and ``device_range`` enter
    no ``record_function`` range (the span still counts); under one, each
    enters its range."""
    from smqtk_indexing_tpu_torch.utils import tracing
    entered = []

    class Recorder:
        def __init__(self, name):
            self.name = name

        def __enter__(self):
            entered.append(self.name)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.profiler, "record_function", Recorder)
    ours = ("test.span", "test.range")

    def both():
        with tracing.trace_span("test.span"), \
                tracing.device_range("test.range"):
            pass

    calls = tracing.COUNTERS.get("span.test.span.calls")
    both()
    assert [e for e in entered if e in ours] == []
    assert tracing.COUNTERS.get("span.test.span.calls") == calls + 1
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        both()
    assert [e for e in entered if e in ours] == list(ours)
    assert tracing.COUNTERS.get("span.test.span.calls") == calls + 2
