"""
The port's LSH index (``models/nn_index/lsh.py``, ``ops/lsh_fused.py``)
against the JAX package's, on 4096 x 32 rows made by numpy from a seed,
hashed by ITQ-16 with the JAX functor's model carried across (its ``.npy``
cache elements), so both indexes hold the same buckets.

- The fused serve's "xor" engine and the two-call path select near codes
  in the same order as the JAX index (distance, then code row), so
  ``nn_many`` agrees with it up to ties in the re-ranked distance.
- The "mxu" engine (K1's bf16 form on the ±1 code table, its plain version
  here; ``SMQTK_TPU_LSH_FUSED_MXU``) breaks ties among codes at the n-th
  Hamming distance its own way, which the HashIndex contract allows: it
  must equal the JAX index on every query without such a tie, and give a
  valid answer on every query (its rows from codes within the n-th
  distance, none better left out among the codes strictly inside it,
  distances exact).
"""
import json
import warnings

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data import (
    DataMemoryElement as JaxDataElement,
    DescriptorMemoryElement as JaxElement,
)
from smqtk_indexing_tpu.models.hash_index.linear import (
    LinearHashIndex as JaxLinear,
)
from smqtk_indexing_tpu.models.lsh_functor.itq import ItqFunctor as JaxItq
from smqtk_indexing_tpu.models.nn_index.lsh import (
    LSHNearestNeighborIndex as JaxLSH,
)
from smqtk_indexing_tpu.ops import metrics as jax_metrics
from smqtk_indexing_tpu_torch.core.configuration import (
    configuration_test_helper, from_config_dict,
)
from smqtk_indexing_tpu_torch.data import (
    DataMemoryElement, DescriptorMemoryElement,
)
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.hash_index.linear import (
    LinearHashIndex,
)
from smqtk_indexing_tpu_torch.models.lsh_functor.itq import ItqFunctor
from smqtk_indexing_tpu_torch.models.nn_index import lsh
from smqtk_indexing_tpu_torch.models.nn_index.lsh import (
    LSHNearestNeighborIndex,
)
from smqtk_indexing_tpu_torch.ops import fused_scan, lsh_fused, metrics
from tests.test_torch_helpers import (
    assert_same_neighbours, assert_valid_lsh_answer,
)

torch.set_num_threads(1)

N, D, BITS, NQ, K = 4096, 32, 16, 48, 10
#: Re-ranked distances: the same f32 elementwise formulas on both sides,
#: summed in different orders.
RTOL, ATOL = 1e-5, 1e-5


def _data(metric, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(N + NQ, D)).astype(np.float32)
    if metric == "hik":
        # HIK is a histogram metric: non-negative vectors.
        x = np.abs(x) / D
    return x[:N], x[N:]


def _functors(x, normalize=None):
    mv, rot = JaxDataElement(), JaxDataElement()
    jf = JaxItq(mv, rot, bit_length=BITS, random_seed=0,
                normalize=normalize)
    jf.fit([JaxElement(i, v) for i, v in enumerate(x[:2000])])
    pf = ItqFunctor(DataMemoryElement(mv.get_bytes()),
                    DataMemoryElement(rot.get_bytes()), bit_length=BITS,
                    random_seed=0, normalize=normalize, device="cpu")
    return pf, jf


def _pair(metric, normalize=None, port_kw=None, jax_kw=None):
    x, q = _data(metric)
    pf, jf = _functors(x, normalize)
    port = LSHNearestNeighborIndex(lsh_functor=pf, distance_method=metric,
                                   device="cpu", **(port_kw or {}))
    ref = JaxLSH(lsh_functor=jf, distance_method=metric, **(jax_kw or {}))
    port.build_index([DescriptorMemoryElement(i, v)
                      for i, v in enumerate(x)])
    ref.build_index([JaxElement(i, v) for i, v in enumerate(x)])
    return port, ref, x, q


@pytest.fixture(scope="module")
def pairs():
    """One built (port, JAX) pair per metric, shared by the parity
    tests."""
    cache = {}

    def get(metric):
        if metric not in cache:
            cache[metric] = _pair(metric)
        return cache[metric]
    return get


def _query(index, q, n, pkg_elem, start=0):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        res = index.nn_many([pkg_elem(("q", start + i), v)
                             for i, v in enumerate(q)], n)
    uids = [[e.uuid() for e in r[0]] for r in res]
    return uids, [list(r[1]) for r in res]


def _assert_same(res, ref):
    (u, d), (u_ref, d_ref) = res, ref
    for i in range(len(u_ref)):
        assert len(u[i]) == len(u_ref[i]), i
        assert_same_neighbours([u[i]], [d[i]], [u_ref[i]], [d_ref[i]],
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("path", ["fused_xor", "two_call"])
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "hik"])
def test_nn_many_matches_jax(pairs, monkeypatch, metric, path):
    port, ref, x, q = pairs(metric)
    if path == "two_call":
        monkeypatch.setenv("SMQTK_TPU_NO_LSH_FUSED", "1")
    served = []
    real = lsh.lsh_fused_query
    monkeypatch.setattr(lsh, "lsh_fused_query",
                        lambda *a, **kw: served.append(kw["engine"])
                        or real(*a, **kw))
    res = _query(port, q, K, DescriptorMemoryElement)
    assert served == ([] if path == "two_call" else ["xor"])
    _assert_same(res, _query(ref, q, K, JaxElement))
    if metric != "hik":
        # Self-queries find themselves first, at distance ~0.
        u, d = _query(port, x[:8], K, DescriptorMemoryElement)
        assert [r[0] for r in u] == list(range(8))
        assert max(r[0] for r in d) < 1e-3


@pytest.mark.parametrize("n", [5, K])
def test_mxu_engine(pairs, monkeypatch, n):
    """SMQTK_TPU_LSH_FUSED_MXU: the ±1 code table through K1's bf16 form
    (plain version on the CPU)."""
    port, ref, x, q = pairs("euclidean")
    monkeypatch.setenv("SMQTK_TPU_LSH_FUSED_MXU", "1")
    port._fused = None                     # the engine is chosen at build
    seen = []
    real = fused_scan.segment_minima
    monkeypatch.setattr(fused_scan, "segment_minima",
                        lambda *a, **kw: seen.append(a[0].dtype)
                        or real(*a, **kw))
    u, d = _query(port, q, n, DescriptorMemoryElement)
    st = port._fused
    assert st["pm1"] is not None and st["pm1"].dtype == torch.bfloat16
    assert st["pm1"].shape[0] % fused_scan.TILE_N == 0
    assert seen == [torch.bfloat16]
    u_ref, d_ref = _query(ref, q, n, JaxElement)
    row_codes = port.lsh_functor.get_hash_batch(x)
    q_codes = port.lsh_functor.get_hash_batch(q)
    uniq = np.unique(row_codes, axis=0)
    untied = 0
    for i in range(NQ):
        assert_valid_lsh_answer(u[i], d[i], q[i], q_codes[i], row_codes,
                                x, n, rtol=RTOL, atol=ATOL)
        s = np.sort((uniq ^ q_codes[i]).sum(-1))
        if s[n - 1] < s[n]:                # no tie at the n-th code
            untied += 1
            assert_same_neighbours([u[i]], [d[i]], [u_ref[i]], [d_ref[i]],
                                   rtol=RTOL, atol=ATOL)
    assert untied > 0
    port._fused = None


def test_normalized_functor_reranks_the_raw_query(monkeypatch):
    """The functor's normalization applies to hashing only: the re-rank
    uses the raw query, on both paths (the JAX index's fix of the fused
    serve)."""
    port, ref, x, q = _pair("euclidean", normalize=2)
    res_f = _query(port, x[:16], K, DescriptorMemoryElement)
    assert port._fused is not None and port._fused["normalize"] == 2
    assert [r[0] for r in res_f[0]] == list(range(16))
    assert max(r[0] for r in res_f[1]) < 1e-3
    _assert_same(res_f, _query(ref, x[:16], K, JaxElement))
    _assert_same(_query(port, q, K, DescriptorMemoryElement),
                 _query(ref, q, K, JaxElement))
    monkeypatch.setenv("SMQTK_TPU_NO_LSH_FUSED", "1")
    _assert_same(_query(port, x[:16], K, DescriptorMemoryElement), res_f)


def test_no_lsh_fused_switch(pairs, monkeypatch):
    port, ref, x, q = pairs("euclidean")
    port._fused = None
    monkeypatch.setenv("SMQTK_TPU_NO_LSH_FUSED", "1")
    assert port._fused_ready(K, NQ) is None
    res = _query(port, q, K, DescriptorMemoryElement)
    assert port._fused is None and port._fallback_hi is not None
    assert port._fallback_hi.device == "cpu"
    _assert_same(res, _query(ref, q, K, JaxElement))
    report = LSHNearestNeighborIndex.usability_report()
    assert report["disabled_flags"] == ["SMQTK_TPU_NO_LSH_FUSED"]
    assert report["degraded"]
    monkeypatch.delenv("SMQTK_TPU_NO_LSH_FUSED")
    assert port._fused_ready(K, NQ) is not None


def test_budget_falls_back_to_two_calls(pairs, monkeypatch):
    port, ref, x, q = pairs("euclidean")
    assert port._fused_ready(K, NQ) is not None
    monkeypatch.setattr(LSHNearestNeighborIndex, "_FUSED_SLOT_BUDGET", 1)
    assert port._fused_ready(K, NQ) is None
    _assert_same(_query(port, q, K, DescriptorMemoryElement),
                 _query(ref, q, K, JaxElement))


def test_single_query_nn(pairs):
    port, ref, x, q = pairs("euclidean")
    for v in (x[17], q[3]):
        nbrs, dists = port.nn(DescriptorMemoryElement("s", v), 4)
        j_nbrs, j_dists = ref.nn(JaxElement("s", v), 4)
        assert_same_neighbours([[e.uuid() for e in nbrs]], [dists],
                               [[e.uuid() for e in j_nbrs]], [j_dists],
                               rtol=RTOL, atol=ATOL)


def test_configured_hash_index_takes_two_calls():
    port, ref, x, q = _pair(
        "euclidean", port_kw={"hash_index": LinearHashIndex(device="cpu")},
        jax_kw={"hash_index": JaxLinear()})
    assert port._fused_ready(K, NQ) is None
    assert port.hash_index.count() == ref.hash_index.count()
    _assert_same(_query(port, q, K, DescriptorMemoryElement),
                 _query(ref, q, K, JaxElement))


def test_mutations_match_jax():
    port, ref, x, q = _pair("euclidean")
    _query(port, q[:4], K, DescriptorMemoryElement)
    assert port._fused is not None
    extra = np.random.default_rng(9).normal(size=(64, D)).astype(np.float32)
    port.update_index([DescriptorMemoryElement(N + i, v)
                       for i, v in enumerate(extra)])
    ref.update_index([JaxElement(N + i, v) for i, v in enumerate(extra)])
    assert port._fused is None and port.count() == ref.count() == N + 64
    gone = list(range(0, N, 7)) + [N + 3]
    port.remove_from_index(gone)
    ref.remove_from_index(gone)
    assert port.count() == ref.count()
    with pytest.raises(KeyError):
        port.remove_from_index([0])
    assert port.count() == ref.count()
    _assert_same(_query(port, q, K, DescriptorMemoryElement),
                 _query(ref, q, K, JaxElement))
    u, _ = _query(port, extra[:4], 3, DescriptorMemoryElement)
    assert [r[0] for r in u] == [N, N + 1, N + 2, u[3][0]]
    assert N + 3 not in u[3]


def test_lsh_fused_query_pads_short_results():
    port, _, x, q = _pair("euclidean")
    st = port._fused_ready(2, 8)
    qp = torch.zeros((8, D))
    qp[:3] = torch.from_numpy(q[:3])
    d, r = lsh_fused.lsh_fused_query(
        st["db"], st["row_valid"], st["packed"], st["code_valid"],
        st["off"], st["ln"], qp, st["mean"], st["proj"], k=4096,
        n_codes=2, n_sel=1, l_max=st["l_max"], metric="euclidean")
    assert d.shape == (8, 4096) and r.dtype == torch.int64
    live = r[:3] >= 0
    assert live.any() and (torch.isinf(d[:3]) == ~live).all()
    assert (r[:3][~live] == -1).all()


def test_config_registry_and_refusals():
    x, _ = _data("euclidean")
    pf, _ = _functors(x)
    index = LSHNearestNeighborIndex(
        lsh_functor=pf, distance_method="euclidean", device="cpu",
        hash_index=LinearHashIndex(device="cpu"))
    for inst in configuration_test_helper(index):
        assert isinstance(inst, LSHNearestNeighborIndex)
        assert inst.device == "cpu" and inst.lsh_functor.device == "cpu"
    cfg = index.get_config()
    json.dumps(cfg)
    assert cfg["hash_index"]["type"].endswith("LinearHashIndex")
    impls = NearestNeighborsIndex.get_impls()
    inst = from_config_dict(
        {"type": "LSHNearestNeighborIndex",
         "LSHNearestNeighborIndex": {
             "device": "cpu",
             "lsh_functor": {"type": "ItqFunctor",
                             "ItqFunctor": {"device": "cpu"}}}}, impls)
    assert type(inst) is LSHNearestNeighborIndex
    assert type(inst.lsh_functor) is ItqFunctor
    with pytest.raises(ValueError, match="power of two"):
        LSHNearestNeighborIndex(lsh_functor=pf, n_devices=3, device="cpu")
    with pytest.raises(ValueError):
        LSHNearestNeighborIndex(lsh_functor=pf, distance_method="l1",
                                device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            LSHNearestNeighborIndex(lsh_functor=pf)


def test_building_and_querying_example(capsys):
    from smqtk_indexing_tpu_torch.examples import building_and_querying
    assert building_and_querying.main(device="cpu") == 32
    out = capsys.readouterr().out
    assert "flat top-5: [('img-0-42', 0.0)" in out
    assert "lsh  top-5: [('img-0-42', 0.0)" in out
    assert "ITQ model reloaded from cache: OK" in out


@pytest.mark.parametrize("name", [
    "euclidean_distance_many", "cosine_distance_many", "hik_distance_many",
    "inner_product_many", "candidate_distances"])
def test_metrics_match_jax(name):
    rng = np.random.default_rng(4)
    q = rng.random((6, 20), dtype=np.float32)
    x = rng.random((50, 20), dtype=np.float32)
    x[3] = 0.0                       # a zero row: cosine's guarded divide
    if name == "candidate_distances":
        cand = x[rng.integers(0, 50, size=(6, 9))]
        for metric in ("euclidean", "cosine", "hik"):
            got = metrics.candidate_distances(
                torch.from_numpy(q), torch.from_numpy(cand), metric)
            want = jax_metrics.candidate_distances(q, cand, metric)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=RTOL, atol=ATOL)
        with pytest.raises(ValueError):
            metrics.candidate_distances(torch.from_numpy(q),
                                        torch.from_numpy(cand), "l1")
        return
    got = getattr(metrics, name)(torch.from_numpy(q), torch.from_numpy(x))
    want = getattr(jax_metrics, name)(q, x)
    assert got.shape == (6, 50) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
