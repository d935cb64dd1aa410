"""
The port's host-streamed tier (``ops/store.HostStreamedVectorStore``,
``FlatNearestNeighborsIndex(storage="host_stream")``) on the CPU: the JAX
package's ``tests/ops/test_host_stream.py`` against the port's device
store, the ``host_stream`` case of ``tests/test_thread_safety.py``, and
the streamed store against the JAX one on the same seeded rows.
"""
import threading

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops.store import (
    HostStreamedVectorStore as JaxHostStreamedVectorStore,
)
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.ops.store import (
    HostStreamedVectorStore, VectorStore,
)
from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS

torch.set_num_threads(1)

@pytest.mark.parametrize("metric", ["euclidean", "cosine",
                                    "inner_product", "hik"])
def test_streamed_matches_device_store(metric):
    # Both stores finish each metric by the same formula on the same rows
    # (inner_product and cosine by K1's elementwise one): bit for bit.
    rng = np.random.default_rng(0)
    n, d = 5000, 24
    db = rng.random((n, d)).astype(np.float32)
    dev = VectorStore(device="cpu")
    hst = HostStreamedVectorStore(block_rows=1024, device="cpu")  # 5 blocks
    dev.build(db, list(range(n)))
    hst.build(db, list(range(n)))
    q = rng.random((7, d)).astype(np.float32)
    d1, u1, _ = dev.knn(q, 9, metric)
    COUNTERS.reset()
    d2, u2, _ = hst.knn(q, 9, metric)
    assert u1 == u2
    np.testing.assert_array_equal(d2, d1)
    assert COUNTERS.get("host_stream.blocks") == 5
    assert COUNTERS.get("host_stream.bytes") == db.nbytes + 5 * n


def test_streamed_mutations_and_masking():
    rng = np.random.default_rng(1)
    n, d = 3000, 16
    db = rng.random((n, d)).astype(np.float32)
    hst = HostStreamedVectorStore(block_rows=1024, device="cpu")
    hst.build(db, list(range(n)))
    hst.add(db[:2] + 0.5, ["a", "b"])
    hst.remove([0, 1])
    assert not hst.has_uid(0) and hst.has_uid("a")
    # Row 2's own vector must now be its nearest neighbor.
    _, uids, _ = hst.knn(db[2:3], 1)
    assert uids[0][0] == 2
    # Masked rows never returned even across block boundaries.
    _, uids, _ = hst.knn(db[0:1], 3)
    assert 0 not in uids[0] and 1 not in uids[0]
    # The added rows' norms are the device store's: "a" is found exactly.
    dist, uids, _ = hst.knn(db[:1] + 0.5, 1)
    assert uids[0] == ["a"] and dist[0, 0] < 1e-6


def test_streamed_rejects_bad_config():
    with pytest.raises(ValueError, match="float32/bfloat16"):
        HostStreamedVectorStore(dtype="sq8", device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        HostStreamedVectorStore(block_rows=1000, device="cpu")
    with pytest.raises(ValueError, match="ONE device"):
        HostStreamedVectorStore(device="cpu", mesh=object())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            HostStreamedVectorStore()


def test_flat_index_host_stream_storage():
    rng = np.random.default_rng(2)
    n, d = 2000, 16
    db = rng.random((n, d)).astype(np.float32)
    elems = [DescriptorMemoryElement(i, db[i]) for i in range(n)]
    idx = FlatNearestNeighborsIndex(storage="host_stream", device="cpu")
    assert isinstance(idx._store, HostStreamedVectorStore)
    idx.build_index(elems)
    e, dd = idx.nn(elems[7], 3)
    assert e[0].uuid() == 7 and dd[0] < 1e-6
    assert idx.get_config()["storage"] == "host_stream"
    ref = FlatNearestNeighborsIndex(device="cpu")
    ref.build_index(elems)
    q = DescriptorMemoryElement("q", rng.random(d).astype(np.float32))
    r1 = idx.nn(q, 5)
    r2 = ref.nn(q, 5)
    assert [x.uuid() for x in r1[0]] == [x.uuid() for x in r2[0]]
    with pytest.raises(ValueError, match="one device"):
        FlatNearestNeighborsIndex(storage="host_stream", n_devices=8,
                                  device="cpu")
    again = FlatNearestNeighborsIndex.from_config(idx.get_config())
    assert isinstance(again._store, HostStreamedVectorStore)


def test_concurrent_queries_and_mutations():
    # tests/test_thread_safety.py's host_stream case.
    rng = np.random.default_rng(0)
    elems = [DescriptorMemoryElement(j, rng.normal(size=16)
                                     .astype(np.float32))
             for j in range(256)]
    idx = FlatNearestNeighborsIndex(storage="host_stream", device="cpu")
    idx.build_index(elems)
    errors = []
    stop = threading.Event()

    def query_loop():
        try:
            while not stop.is_set():
                res, dists = idx.nn(elems[rng.integers(0, 128)], 3)
                assert len(res) == len(dists) <= 3
                assert list(dists) == sorted(dists)
        except Exception as e:  # pragma: no cover - failure capture
            errors.append(e)

    def mutate_loop():
        try:
            for i in range(10):
                uid = f"new-{i}"
                idx.update_index([DescriptorMemoryElement(
                    uid, rng.normal(size=16).astype(np.float32))])
                idx.remove_from_index([uid])
        except Exception as e:  # pragma: no cover
            errors.append(e)

    threads = [threading.Thread(target=query_loop) for _ in range(4)]
    m = threading.Thread(target=mutate_loop)
    for t in threads:
        t.start()
    m.start()
    m.join()
    stop.set()
    for t in threads:
        t.join()
    assert not errors, errors
    assert idx.count() == 256


@pytest.mark.parametrize("metric,dtype", [
    ("euclidean", "float32"), ("cosine", "float32"),
    ("inner_product", "float32"), ("hik", "float32"),
    ("euclidean", "bfloat16")])
def test_streamed_matches_jax_streamed_store(metric, dtype):
    # The same seeded rows, a removal and an append through both packages'
    # streamed stores (three blocks, the last one short).
    rng = np.random.default_rng(3)
    n, d = 2600, 20
    db = rng.random((n, d)).astype(np.float32)
    extra = rng.random((40, d)).astype(np.float32)
    q = rng.random((11, d)).astype(np.float32)
    out = []
    for store in (HostStreamedVectorStore(dtype=dtype, block_rows=1024,
                                          device="cpu"),
                  JaxHostStreamedVectorStore(dtype=dtype, block_rows=1024)):
        store.build(db, list(range(n)))
        store.remove(list(range(0, n, 7)))
        store.add(extra, [("x", i) for i in range(40)])
        out.append(store.knn(q, 12, metric))
    (d_p, u_p, r_p), (d_j, u_j, r_j) = out
    assert u_p == u_j
    np.testing.assert_array_equal(r_p, np.asarray(r_j))
    np.testing.assert_allclose(d_p, d_j, rtol=0, atol=1e-5)
