"""
The port's ``FlatNearestNeighborsIndex`` end to end, on the CPU, against
the JAX package's index and a float64 oracle: build -> update -> remove ->
``nn_many`` for every metric and for float32 / bfloat16 storage, the
configuration round-trip, the interface's contract probes, and persisted
payloads loading across the two packages in both directions.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import flat as jax_flat
from smqtk_indexing_tpu.ops.store import VectorStore as JaxVectorStore
from smqtk_indexing_tpu_torch.core.configuration import (
    configuration_test_helper, from_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index import flat as port_flat
from smqtk_indexing_tpu_torch.ops.store import VectorStore
from tests.test_torch_helpers import assert_same_neighbours, elements_for

torch.set_num_threads(1)

PORT_KEY = ("smqtk_indexing_tpu_torch.models.nn_index.flat."
            "FlatNearestNeighborsIndex")
JAX_KEY = "smqtk_indexing_tpu.models.nn_index.flat.FlatNearestNeighborsIndex"
METRICS = ("euclidean", "inner_product", "cosine", "hik", "chi_square")
N, D, N_Q, K = 1500, 40, 20, 8
REMOVED = list(range(0, N, 10))

#: Distances, port vs JAX. float32: the same exact f32 formulas summed in
#: different orders. bfloat16: the JAX CPU scan picks its k rows by a
#: surrogate computed from the query rounded to bf16 with no re-rank margin
#: (ops/scan.py flat_topk), and sums hik / chi_square in bf16, so its
#: distances carry up to ~2^-7 relative error and it can keep a near
#: neighbour in place of a true one (measured: 6e-3 relative at most
#: here); the port is held to the float64 oracle below instead.
TOL_VS_JAX = {"float32": (1e-5, 1e-6), "bfloat16": (1e-2, 1e-2)}
#: Distances, port vs float64 on the stored (bf16-rounded) rows: f32
#: summation order only.
TOL_VS_F64 = (1e-5, 1e-5)


def _elements():
    rng = np.random.default_rng(0)
    x = rng.random((N, D), dtype=np.float32)
    q = rng.random((N_Q, D), dtype=np.float32)
    return ([DescriptorMemoryElement(i, x[i]) for i in range(N)],
            [DescriptorMemoryElement(("q", i), q[i]) for i in range(N_Q)],
            x, q)


ELEMS, QUERIES, X, Q = _elements()


def _flow(index):
    """build -> update -> remove -> nn_many, with ``index``'s own
    elements; (uids, dists) arrays."""
    elems = elements_for(index, ELEMS)
    index.build_index(elems[:1200])
    index.update_index(elems[1200:])
    index.remove_from_index(REMOVED)
    assert index.count() == N - len(REMOVED)
    res = index.nn_many(elements_for(index, QUERIES), K)
    return (np.array([[e.uuid() for e in r[0]] for r in res]),
            np.array([r[1] for r in res], dtype=np.float64))


def _oracle(metric, dtype):
    """float64 top-K (uids, dists) over the live rows as the port stores
    them (bf16-rounded for bfloat16; hik / chi_square also round the
    query, as the scan casts queries to the storage dtype). Cosine divides
    by the norms of the rows as given, which both packages keep in f32."""
    def rounded(a):
        return torch.from_numpy(a).to(getattr(torch, dtype)).double() \
            .numpy()
    x, q = rounded(X), Q.astype(np.float64)
    if metric in ("hik", "chi_square"):
        q = rounded(Q)
    if metric == "euclidean":
        dist = np.sqrt(((q[:, None, :] - x[None]) ** 2).sum(-1))
    elif metric == "inner_product":
        dist = -(q @ x.T)
    elif metric == "cosine":
        sim = (q @ x.T) / np.outer(
            np.linalg.norm(q, axis=1),
            np.linalg.norm(X.astype(np.float64), axis=1))
        dist = 2.0 * np.arccos(np.clip(sim, -1, 1)) / np.pi
    elif metric == "hik":
        dist = 1.0 - np.minimum(q[:, None, :], x[None]).sum(-1)
    else:
        s = q[:, None, :] + x[None]
        dist = np.where(s > 0, (q[:, None, :] - x[None]) ** 2
                        / np.where(s > 0, s, 1), 0).sum(-1)
    dist[:, REMOVED] = np.inf
    order = np.argsort(dist, axis=1, kind="stable")[:, :K]
    return order, np.take_along_axis(dist, order, 1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_matches_jax(metric, dtype):
    u_ref, d_ref = _flow(jax_flat.FlatNearestNeighborsIndex(
        metric=metric, dtype=dtype))
    u_port, d_port = _flow(port_flat.FlatNearestNeighborsIndex(
        metric=metric, dtype=dtype, device="cpu"))
    assert_same_neighbours(u_port, d_port, u_ref, d_ref,
                           *TOL_VS_JAX[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", METRICS)
def test_flat_matches_float64_oracle(metric, dtype):
    u_port, d_port = _flow(port_flat.FlatNearestNeighborsIndex(
        metric=metric, dtype=dtype, device="cpu"))
    u_ref, d_ref = _oracle(metric, dtype)
    assert_same_neighbours(u_port, d_port, u_ref, d_ref, *TOL_VS_F64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_persisted_payload_loads_across_packages(direction, dtype):
    # Each package's index reads its own data element.
    src_cls, dst_cls, src_kw, dst_kw = (
        jax_flat.FlatNearestNeighborsIndex,
        port_flat.FlatNearestNeighborsIndex,
        {"index_element": JaxDataMemoryElement()}, {"device": "cpu"})
    if direction == "port_to_jax":
        src_cls, dst_cls = dst_cls, src_cls
        src_kw = {"index_element": DataMemoryElement(), "device": "cpu"}
        dst_kw = {}
    src = src_cls(dtype=dtype, **src_kw)
    u_src, d_src = _flow(src)
    dst_elem = DataMemoryElement if direction == "jax_to_port" \
        else JaxDataMemoryElement
    dst = dst_cls(index_element=dst_elem(src_kw["index_element"].get_bytes()),
                  dtype=dtype, **dst_kw)
    assert dst.count() == src.count()
    res = dst.nn_many(elements_for(dst, QUERIES), K)
    u_dst = np.array([[e.uuid() for e in r[0]] for r in res])
    d_dst = np.array([r[1] for r in res], dtype=np.float64)
    assert_same_neighbours(u_dst, d_dst, u_src, d_src, *TOL_VS_JAX[dtype])


def test_store_load_state_matches_jax_store_rows():
    # The JAX store's host state, tombstones included, carried row for row:
    # row ids of the results are the JAX store's.
    jax_store = JaxVectorStore()
    jax_store.build(X[:1200], list(range(1200)))
    jax_store.add(X[1200:], list(range(1200, N)))
    jax_store.remove(REMOVED)
    port_store = VectorStore(device="cpu")
    port_store.load_state(jax_store._host, jax_store._row2uid,
                          jax_store._valid_host)
    assert port_store.n_valid == jax_store.n_valid
    assert port_store.uids() == jax_store.uids()
    d_ref, u_ref, r_ref = jax_store.knn(Q, K)
    d_port, u_port, r_port = port_store.knn(Q, K)
    np.testing.assert_array_equal(r_port, r_ref)
    assert u_port == u_ref
    np.testing.assert_allclose(d_port, d_ref, rtol=1e-5)


def test_configuration_round_trip():
    inst = port_flat.FlatNearestNeighborsIndex(
        metric="cosine", dtype="bfloat16", read_only=True, device="cpu")
    for i in configuration_test_helper(inst):
        assert isinstance(i, port_flat.FlatNearestNeighborsIndex)
        assert (i.metric, i.dtype, i.read_only, i.device) == \
            ("cosine", "bfloat16", True, "cpu")
    json.dumps(port_flat.FlatNearestNeighborsIndex.get_default_config())


def test_fully_qualified_key_selects_the_port():
    # The port has its own interfaces and registry: its get_impls() holds
    # its own class and not the JAX package's, though both are imported
    # here, so the qualified key and the bare name select the port and the
    # JAX package's key matches nothing.
    impls = NearestNeighborsIndex.get_impls()
    assert port_flat.FlatNearestNeighborsIndex in impls
    assert jax_flat.FlatNearestNeighborsIndex not in impls
    for key in (PORT_KEY, "FlatNearestNeighborsIndex"):
        inst = from_config_dict({"type": key, key: {"device": "cpu"}}, impls)
        assert type(inst) is port_flat.FlatNearestNeighborsIndex
    with pytest.raises(ValueError, match="does not match"):
        from_config_dict({"type": JAX_KEY}, impls)


def test_contract_probes():
    idx = port_flat.FlatNearestNeighborsIndex(device="cpu")
    with pytest.raises(ValueError):
        idx.build_index([])
    with pytest.raises(ValueError):
        idx.nn(QUERIES[0], 1)
    idx.build_index(ELEMS[:10])
    with pytest.raises(KeyError):
        idx.remove_from_index([3, "unknown"])
    assert idx.count() == 10
    with pytest.raises(ValueError):
        idx.nn(DescriptorMemoryElement("empty"), 1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        neighbours, dists = idx.nn(QUERIES[0], 25)
    assert len(neighbours) == len(dists) == 10
    assert any("only 10" in str(w.message) for w in caught)
    ro = port_flat.FlatNearestNeighborsIndex(read_only=True, device="cpu")
    for call in (lambda: ro.build_index(ELEMS[:3]),
                 lambda: ro.update_index(ELEMS[:3]),
                 lambda: ro.remove_from_index([0])):
        with pytest.raises(ReadOnlyError):
            call()


def test_unported_options_raise():
    # The codecs are ported; OPQ under hik and the compressed codecs under
    # chi_square are refused, as in the JAX package, and so is a shard
    # count that is not a power of two.
    for kw in ({"dtype": "opq16", "metric": "hik"},
               {"dtype": "sq8", "metric": "chi_square"}, {"dtype": "pq4x2"},
               {"storage": "host_stream"}, {"n_devices": 3},
               {"metric": "manhattan"}):
        with pytest.raises(ValueError):
            port_flat.FlatNearestNeighborsIndex(device="cpu", **kw)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_flat.FlatNearestNeighborsIndex()
    report = port_flat.FlatNearestNeighborsIndex.usability_report()
    assert report["usable"] is True
    assert report["kernel_tier"] == "cpu-reference"
    assert report["degraded"] is True
