"""
The port's ``IvfNearestNeighborsIndex`` against the JAX package's, on the
CPU. The JAX index is built, its persisted payload (centroids,
assignments, list-sorted rows or codes, SQ8 codec) is loaded into the
port, and ``nn_many`` is compared, so both query the same trained state
(a separate k-means run may break near ties its own way). Payloads load in
both directions. The data is clustered like ``bench.py``'s serving line:
d=96 (padded to 128), 6,000 rows over 2 tiles, 16 lists, 8 held-out
queries.
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import ivf as jax_ivf
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index import ivf as port_ivf
from smqtk_indexing_tpu_torch.ops import fused_scan, ivf_scan
from tests.test_torch_helpers import assert_same_neighbours, elements_for

torch.set_num_threads(1)

N, D, N_Q, K, LISTS = 6000, 96, 8, 10, 16
#: Distances, port vs JAX, where both compute exact f32 distances in
#: different orders (rows tier; code tier with rerank='exact').
EXACT_TOL = (1e-5, 1e-5)
#: Score mode: the JAX CPU run goes through the TPU kernel's split-bf16
#: product, whose residual is ~2^-16 of ||q - b||^2 + s2 (about 50 here)
#: on the squared distance (tests/ops/test_pallas_ivf_tiled.py:204-209);
#: the port's kernel has none. Per metric, with a 4x margin: euclidean
#: and inner_product 5e-3 absolute, cosine (unit rows) 2e-3.
SCORE_ATOL = {"euclidean": 5e-3, "inner_product": 5e-3, "cosine": 2e-3}


def _data():
    rng = np.random.default_rng(2)
    centres = rng.random((64, D), dtype=np.float32)
    pts = centres[rng.integers(0, 64, size=N + N_Q)]
    pts = pts + rng.normal(size=pts.shape).astype(np.float32) / 12
    pts = np.clip(pts, 0, 1).astype(np.float32)
    return pts[:N], pts[N:]


X, Q = _data()
ELEMS = [DescriptorMemoryElement(i, X[i]) for i in range(N)]
QUERIES = [DescriptorMemoryElement(("q", i), Q[i]) for i in range(N_Q)]


def _result(index, queries=QUERIES, k=K):
    """``nn_many`` with ``index``'s own elements; (uids, dists) arrays."""
    res = index.nn_many(elements_for(index, queries), k)
    return (np.array([[e.uuid() for e in r[0]] for r in res]),
            np.array([r[1] for r in res], dtype=np.float64))


def _kw(storage, dtype, metric, rerank, nprobe=4):
    return dict(n_lists=LISTS, nprobe=nprobe, random_seed=0, metric=metric,
                dtype=dtype, storage=storage, rerank=rerank)


def _jax_then_port(storage, dtype, metric, rerank, nprobe=4):
    """Build the JAX index, load its payload into the port; (jax, port)."""
    kw = _kw(storage, dtype, metric, rerank, nprobe)
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(index_element=elem, **kw)
    ref.build_index(elements_for(ref, ELEMS))
    port = port_ivf.IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cpu",
        **kw)
    return ref, port


def _compare(port, ref, metric, rerank, storage):
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert u_p.shape == (N_Q, K)
    if storage == "code" and rerank == "score":
        assert_same_neighbours(u_p, d_p, u_r, d_r, rtol=0.0,
                               atol=SCORE_ATOL[metric])
    else:
        assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)


@pytest.mark.parametrize("rerank", ["score", "exact"])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_code_tier_matches_jax(metric, rerank):
    ref, port = _jax_then_port("code", "sq8", metric, rerank)
    np.testing.assert_array_equal(port._host, ref._host)
    np.testing.assert_array_equal(port._s2t.numpy(), np.asarray(ref._s2t))
    np.testing.assert_array_equal(port._dev3.numpy(), np.asarray(ref._dev3))
    np.testing.assert_array_equal(port._slot_table.numpy(),
                                  np.asarray(ref._slot_table))
    tiled = ivf_scan.LAUNCHES["ivf_list_scores_tiled"]
    _compare(port, ref, metric, rerank, "code")
    # On the CPU the wrappers take the plain versions: no kernel launch.
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled"] == tiled


@pytest.mark.parametrize("dtype,metric,rerank", [
    ("float32", "euclidean", "exact"),
    ("bfloat16", "euclidean", "exact"),
    ("sq8", "euclidean", "exact"),
    ("sq8", "euclidean", "score"),
    ("float32", "cosine", "exact"),
])
def test_rows_tier_matches_jax(dtype, metric, rerank):
    ref, port = _jax_then_port("rows", dtype, metric, rerank)
    engine = "tiled" if port._dev3 is not None else \
        ("dma" if port._dma_eligible() else "gather")
    if engine != "tiled":
        # The balancer builds the same sublists in both packages.
        for name in ("_dev_offsets", "_dev_lens", "_dev_first_virt"):
            np.testing.assert_array_equal(getattr(port, name).numpy(),
                                          np.asarray(getattr(ref, name)))
        assert (port._max_split, port._l_max) == (ref._max_split,
                                                  ref._l_max)
    assert engine == {"euclidean": "tiled" if rerank == "score" else "dma",
                      "cosine": "gather"}[metric]
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    if dtype == "sq8" and rerank == "score":
        # The port routes rows-sq8 score mode to the tiled engine, as the
        # JAX package does on a TPU; on the CPU the JAX index takes its
        # exact list scan, so its distances carry no surrogate noise.
        assert_same_neighbours(u_p, d_p, u_r, d_r, rtol=0.0, atol=1e-4)
    else:
        assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)


@pytest.mark.parametrize("storage,dtype,metric,rerank", [
    ("code", "sq8", "euclidean", "score"),
    ("code", "sq8", "cosine", "exact"),
    ("rows", "float32", "euclidean", "exact"),
])
def test_port_payload_loads_in_jax(storage, dtype, metric, rerank):
    kw = _kw(storage, dtype, metric, rerank)
    elem = DataMemoryElement()
    port = port_ivf.IvfNearestNeighborsIndex(index_element=elem,
                                             device="cpu", **kw)
    port.build_index(ELEMS)
    port.remove_from_index([3, 4, 5])
    ref = jax_ivf.IvfNearestNeighborsIndex(
        index_element=JaxDataMemoryElement(elem.get_bytes()), **kw)
    assert ref.count() == port.count() == N - 3
    np.testing.assert_array_equal(np.asarray(ref._centroids_np),
                                  port._centroids_np)
    _compare(port, ref, metric, rerank, storage)


def test_exhaustive_probe_is_exact():
    # nprobe >= n_lists probes every sublist: the float64 top-k.
    port = port_ivf.IvfNearestNeighborsIndex(
        device="cpu", **_kw("rows", "float32", "euclidean", "exact",
                            nprobe=LISTS))
    port.build_index(ELEMS)
    u_p, d_p = _result(port)
    dist = np.sqrt(((Q[:, None, :].astype(np.float64) - X[None]) ** 2)
                   .sum(-1))
    ref = np.argsort(dist, axis=1, kind="stable")[:, :K]
    assert_same_neighbours(u_p, d_p, ref, np.take_along_axis(dist, ref, 1),
                           *EXACT_TOL)


def test_exhaustive_code_tier_is_exact_on_the_codes():
    port = port_ivf.IvfNearestNeighborsIndex(
        device="cpu", **_kw("code", "sq8", "euclidean", "exact",
                            nprobe=LISTS))
    port.build_index(ELEMS)
    before = dict(fused_scan.LAUNCHES)
    u_p, d_p = _result(port)
    assert fused_scan.LAUNCHES == before
    decoded = np.stack([port._row_vector(i)
                        for i in range(port._host.shape[0])])
    uids = np.array(port._row2uid)
    dist = np.sqrt(((Q[:, None, :].astype(np.float64)
                     - decoded[None].astype(np.float64)) ** 2).sum(-1))
    order = np.argsort(dist, axis=1, kind="stable")[:, :K]
    assert_same_neighbours(u_p, d_p, uids[order],
                           np.take_along_axis(dist, order, 1), *EXACT_TOL)


def test_same_seed_gives_the_same_kmeans_init_as_jax():
    kw = _kw("rows", "float32", "euclidean", "exact")
    kw["kmeans_iterations"] = 0          # centroids are the init itself
    ref = jax_ivf.IvfNearestNeighborsIndex(**kw)
    port = port_ivf.IvfNearestNeighborsIndex(device="cpu", **kw)
    np.testing.assert_array_equal(port._train_centroids(X),
                                  np.asarray(ref._train_centroids(X)))
