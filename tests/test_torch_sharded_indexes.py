"""
The port's sharded stores and indexes (``n_devices`` / ``mesh=``) against
the JAX package's sharded ones, on the CPU: the port's shards all on the
CPU, JAX's on tier-1's 8 virtual CPU devices. Inputs are numpy arrays
made from a seed and fed to both packages.

Trained state is not bit-equal across packages (k-means, PQ codebooks,
OPQ rotations, MRPT trees), so the IVF and MRPT tests build the JAX
sharded index and load its payload into the port's (``n_devices`` is
configuration, not payload), and the flat PQ / OPQ tests hand the port's
trainers the JAX store's codec. Each route runs at one of the mesh sizes
2, 4 and 8 so that every size is covered; the stores also run on the 2-D
(dcn=2, shard=4) mesh.

Tolerances: rows equal the JAX package's except for near ties at the k-th
place (``assert_same_neighbours``). Distances: exact f32 formulas in other
orders, 1e-5 relative and absolute (``EXACT_TOL``); the code tier's score
mode, where JAX's interpret-mode kernel leaves its split-bf16 residual,
``SCORE_ATOL`` of ``tests/test_torch_ivf.py``; Hamming distances exactly.
"""
import json
import warnings

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.hash_index.linear import (
    LinearHashIndex as JaxLinear,
)
from smqtk_indexing_tpu.models.nn_index import flat as jax_flat
from smqtk_indexing_tpu.models.nn_index import ivf as jax_ivf
from smqtk_indexing_tpu.models.nn_index import mrpt as jax_mrpt
from smqtk_indexing_tpu.ops.hamming import CodeStore as JaxCodeStore
from smqtk_indexing_tpu.ops.store import VectorStore as JaxVectorStore
from smqtk_indexing_tpu.parallel import mesh as jax_mesh
from smqtk_indexing_tpu_torch.core.configuration import (
    configuration_test_helper,
)
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.hash_index.linear import (
    LinearHashIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index import flat as port_flat
from smqtk_indexing_tpu_torch.models.nn_index import ivf as port_ivf
from smqtk_indexing_tpu_torch.models.nn_index import mrpt as port_mrpt
from smqtk_indexing_tpu_torch.models.nn_index.factory import (
    index_from_factory_string,
)
from smqtk_indexing_tpu_torch.ops import opq, pq
from smqtk_indexing_tpu_torch.ops.hamming import CodeStore
from smqtk_indexing_tpu_torch.ops.store import VectorStore
from smqtk_indexing_tpu_torch.parallel import mesh
from tests.test_torch_helpers import assert_same_neighbours, elements_for
from tests.test_torch_ivf import SCORE_ATOL

torch.set_num_threads(1)

EXACT_TOL = (1e-5, 1e-5)
N, D, NQ, K = 3000, 24, 6, 8

_rng = np.random.default_rng(12)
X = _rng.random((N, D), dtype=np.float32)
Q = _rng.random((NQ, D), dtype=np.float32)
ELEMS = [DescriptorMemoryElement(i, X[i]) for i in range(N)]
QUERIES = [DescriptorMemoryElement(("q", i), Q[i]) for i in range(NQ)]


def _result(index, queries=QUERIES, k=K):
    res = index.nn_many(elements_for(index, queries), k)
    return (np.array([[e.uuid() for e in r[0]] for r in res]),
            np.array([r[1] for r in res], dtype=np.float64))


def _same(port, ref, tol=EXACT_TOL):
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert u_p.shape == u_r.shape == (NQ, K)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *tol)


# ---------------------------------------------------------------------------
# the stores, on 1-D and 2-D meshes
# ---------------------------------------------------------------------------

def _adopt_jax_codec(monkeypatch, cb, rot):
    """The port's PQ / OPQ trainers return the JAX store's codec."""
    cb = np.asarray(cb)
    monkeypatch.setattr(pq, "pq_train", lambda live, m, **_: cb)
    monkeypatch.setattr(opq, "opq_train", lambda live, m, **_: (rot, cb))


@pytest.mark.parametrize("dtype,metric,n,dcn", [
    ("float32", "euclidean", 8, 2), ("float32", "hik", 2, 1),
    ("bfloat16", "cosine", 4, 1), ("sq8", "inner_product", 8, 2),
    ("pq4", "euclidean", 8, 1), ("opq4", "cosine", 8, 2)])
def test_vector_store_mesh_matches_jax(monkeypatch, dtype, metric, n, dcn):
    pm = mesh.make_mesh(n, device="cpu", dcn=dcn)
    jm = jax_mesh.make_mesh(n, dcn=dcn)
    ref = JaxVectorStore(dtype, mesh=jm)
    ref.build(X[:2000], list(range(2000)))
    if pq.pq_m(dtype) is not None:
        _adopt_jax_codec(monkeypatch, ref._pq_cb, ref._pq_rot)
    port = VectorStore(dtype, mesh=pm)
    port.build(X[:2000], list(range(2000)))
    assert len(port._dev) == n and port._dev[0].shape[0] == 2048 // n
    # Growth past the capacity, removal, then compaction: each re-shards.
    for store in (ref, port):
        store.add(X[2000:], list(range(2000, N)))
        store.remove(list(range(0, N, 3)))
    for drop in ([u for u in range(N) if u % 3 and u % 4], None):
        d_p, u_p, _ = port.knn(Q, K, metric)
        d_j, u_j, _ = ref.knn(Q, K, metric)
        assert_same_neighbours(np.array(u_p), d_p, np.array(u_j), d_j,
                               *EXACT_TOL)
        for store in (ref, port) if drop else ():
            store.remove(drop)
    assert port.n_valid == ref.n_valid < N // 2


@pytest.mark.parametrize("n,dcn", [(2, 1), (8, 2)], ids=["s2", "dcn2x4"])
def test_code_store_mesh_matches_jax(n, dcn):
    rng = np.random.default_rng(13)
    codes = rng.random((3000, 24)) > 0.5
    q = rng.random((5, 24)) > 0.5
    port = CodeStore(mesh=mesh.make_mesh(n, device="cpu", dcn=dcn))
    ref = JaxCodeStore(mesh=jax_mesh.make_mesh(n, dcn=dcn))
    for store in (port, ref):
        store.build(codes[:2000])
        store.add(codes[2000:])
        store.remove(codes[:500])
    assert port.n_valid == ref.n_valid
    d_p, c_p = port.knn(q, 12)
    d_j, c_j = ref.knn(q, 12)
    np.testing.assert_array_equal(d_p, d_j)
    # Ties at the 12th distance aside, the same codes.
    for i in range(q.shape[0]):
        inner = d_p[i] < d_p[i, -1]
        np.testing.assert_array_equal(c_p[i][inner], c_j[i][inner])
    assert port.to_bytes() == ref.to_bytes()


# ---------------------------------------------------------------------------
# the indexes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,n", [("float32", 2), ("sq8", 4),
                                     ("pq4", 8)])
def test_flat_index_n_devices_matches_jax(monkeypatch, dtype, n):
    ref = jax_flat.FlatNearestNeighborsIndex(dtype=dtype, n_devices=n)
    ref.build_index(elements_for(ref, ELEMS))
    if dtype == "pq4":
        _adopt_jax_codec(monkeypatch, ref._store._pq_cb, None)
    port = port_flat.FlatNearestNeighborsIndex(dtype=dtype, n_devices=n,
                                               device="cpu")
    port.build_index(ELEMS)
    assert port._store._mesh.size == n
    _same(port, ref)
    for index in (ref, port):
        index.remove_from_index(list(range(0, 40)))
        index.update_index(elements_for(index, ELEMS[:10]))
    _same(port, ref)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_linear_hash_index_n_devices_matches_jax(n):
    rng = np.random.default_rng(14)
    codes = rng.random((2500, 20)) > 0.5
    port = LinearHashIndex(n_devices=n, device="cpu")
    ref = JaxLinear(n_devices=n)
    for index in (port, ref):
        index.build_index(codes)
    assert port._store._mesh.size == n
    for h in codes[:4]:
        c_p, d_p = port.nn(h, 10)
        c_j, d_j = ref.nn(h, 10)
        assert d_p == d_j
        inner = np.asarray(d_p) < d_p[-1]
        np.testing.assert_array_equal(np.asarray(c_p)[inner],
                                      np.asarray(c_j)[inner])


@pytest.mark.parametrize("n", [2, 4])
def test_lsh_n_devices_matches_jax(n):
    from tests.test_torch_lsh import _pair
    port, ref, x, q = _pair("euclidean", port_kw={"n_devices": n},
                            jax_kw={"n_devices": n})
    assert port._fused_ready(K, 4) is None
    qp = [DescriptorMemoryElement(("q", i), v) for i, v in enumerate(q[:6])]
    res_p = port.nn_many(qp, K)
    res_j = ref.nn_many(elements_for(ref, qp), K)
    assert port._fallback_hi._store._mesh.size == n
    u_p = np.array([[e.uuid() for e in r[0]] for r in res_p])
    u_j = np.array([[e.uuid() for e in r[0]] for r in res_j])
    assert_same_neighbours(u_p, [r[1] for r in res_p], u_j,
                           [r[1] for r in res_j], *EXACT_TOL)


#: IVF cells: (storage, dtype, metric, rerank, residual, n_devices).
IVF_CELLS = [
    ("code", "sq8", "euclidean", "score", False, 8),
    ("code", "sq8", "inner_product", "exact", False, 2),
    ("code", "pq4", "euclidean", "exact", False, 2),
    ("code", "pq4", "euclidean", "score", True, 4),
    ("rows", "float32", "euclidean", "exact", False, 8),
    ("rows", "sq8", "cosine", "exact", False, 2),
    ("rows", "pq4", "euclidean", "exact", True, 4),
]


def _ivf_pair(storage, dtype, metric, rerank, residual, n):
    kw = dict(n_lists=16, nprobe=4, random_seed=0, metric=metric,
              dtype=dtype, storage=storage, rerank=rerank,
              pq_residual=residual, n_devices=n)
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(index_element=elem, **kw)
    ref.build_index(elements_for(ref, ELEMS))
    port = port_ivf.IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cpu",
        **kw)
    return ref, port


@pytest.mark.parametrize("storage,dtype,metric,rerank,residual,n",
                         IVF_CELLS)
def test_ivf_n_devices_matches_jax(storage, dtype, metric, rerank,
                                   residual, n):
    ref, port = _ivf_pair(storage, dtype, metric, rerank, residual, n)
    assert port._mesh is not None and port._mesh.size == n
    tiled = storage == "code"
    assert (port._dev3 is not None) == tiled
    assert not port._dma_eligible()
    tol = (0.0, SCORE_ATOL[metric]) if rerank == "score" and tiled \
        else EXACT_TOL
    _same(port, ref, tol)
    if tiled and rerank == "exact":
        return                  # the score-mode cells mutate the tiles
    # remove / add under the mesh: poisoned stats or a re-sharded mask,
    # then a re-layout through the sharded upload.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for index in (ref, port):
            index.remove_from_index(list(range(0, 30)))
            index.update_index(elements_for(index, ELEMS[:5]))
    assert port.count() == ref.count() == N - 25
    _same(port, ref, tol)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mrpt_n_devices_matches_jax(n):
    elem = JaxDataMemoryElement()
    ref = jax_mrpt.MRPTNearestNeighborsIndex(
        index_element=elem, num_trees=6, depth=4, random_seed=0,
        n_devices=n)
    ref.build_index(elements_for(ref, ELEMS))
    port = port_mrpt.MRPTNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), num_trees=6,
        depth=4, random_seed=0, n_devices=n, device="cpu")
    assert port._mesh.size == n and port._mirror is None
    assert port._leaf_max_sh == ref._leaf_max_sh
    _same(port, ref)


def test_config_round_trip_with_a_device_list():
    for index in (
            port_flat.FlatNearestNeighborsIndex(
                n_devices=2, device=["cpu", "cpu"]),
            port_ivf.IvfNearestNeighborsIndex(
                n_lists=4, n_devices=4, device=["cpu"] * 4),
            port_mrpt.MRPTNearestNeighborsIndex(
                n_devices=2, device=["cpu", "cpu"]),
            LinearHashIndex(n_devices=2, device=["cpu", "cpu"])):
        for inst in configuration_test_helper(index):
            cfg = inst.get_config()
            assert cfg["device"] == index.get_config()["device"]
            assert cfg["n_devices"] == index.n_devices
            json.dumps(cfg)
        assert isinstance(index.get_config()["device"], list)
    with pytest.raises(ValueError, match="n_devices"):
        port_flat.FlatNearestNeighborsIndex(n_devices=4,
                                            device=["cpu", "cpu"])


def test_one_device_list_means_no_mesh():
    """``n_devices`` None or 1 is one device whatever form ``device``
    takes, as the JAX ``_make_mesh`` returns None for ``n_devices <= 1``:
    a one-device list only names the primary device."""
    for n in (None, 1):
        assert mesh.mesh_for(n, "cpu") is None
        assert mesh.mesh_for(n, ["cpu"]) is None
    with pytest.raises(ValueError, match="n_devices"):
        mesh.mesh_for(1, ["cpu", "cpu"])
    with pytest.raises(ValueError, match="n_devices"):
        mesh.mesh_for(None, ["cpu", "cpu"])
    flat = port_flat.FlatNearestNeighborsIndex(n_devices=1, device=["cpu"])
    ivf = port_ivf.IvfNearestNeighborsIndex(
        n_lists=16, nprobe=4, random_seed=0, n_devices=1, device=["cpu"])
    mrpt = port_mrpt.MRPTNearestNeighborsIndex(
        num_trees=6, depth=4, random_seed=0, n_devices=1, device=["cpu"])
    hi = LinearHashIndex(n_devices=1, device=["cpu"])
    assert ivf._mesh_cfg is None and mrpt._mesh_cfg is None
    assert hi._mesh is None and hi._store._mesh is None
    for index, one in (
            (flat, port_flat.FlatNearestNeighborsIndex(device="cpu")),
            (ivf, port_ivf.IvfNearestNeighborsIndex(
                n_lists=16, nprobe=4, random_seed=0, device="cpu"))):
        index.build_index(ELEMS)
        one.build_index(ELEMS)
        assert index.get_config()["device"] == ["cpu"]
        _same(index, one)
    assert flat._store._mesh is None and ivf._mesh is None
    mrpt.build_index(ELEMS)
    assert mrpt._mesh is None


def test_factory_string_with_n_devices():
    index = index_from_factory_string("IVF16,SQ8", "l2", n_devices=2,
                                      device="cpu", random_seed=0)
    assert isinstance(index, port_ivf.IvfNearestNeighborsIndex)
    assert index.n_devices == 2 and index._mesh_cfg.size == 2
    index.build_index(ELEMS[:1000])
    assert index._mesh.size == 2
    flat = index_from_factory_string("Flat", "l2", n_devices=4,
                                     device="cpu")
    flat.build_index(ELEMS[:500])
    uids = [e.uuid() for e in flat.nn(ELEMS[7], 3)[0]]
    assert uids[0] == 7


def test_dryrun_multichip_at_four():
    from smqtk_indexing_tpu_torch.examples import multichip
    multichip.dryrun_multichip(4, device="cpu")
    multichip.main(["--device", "cpu", "--n-devices", "2"])
