"""
The port's MRPT (``ops/mrpt.py``, ``models/nn_index/mrpt.py``) against the
JAX package's, on the CPU, and the reference behaviours of
``tests/impls/nn_index/test_mrpt.py`` on the port alone.

The ops take the same numpy inputs in both packages, with the trees built
from the JAX projections (the projections of the two backends agree to
rounding, not bit for bit, so each package's own build may split a near
tie its own way). JAX's mirror query runs its Pallas kernel in interpret
mode; the port's runs K6's plain version. The indexes carry state across
through the persisted payload, which either package loads; on the CPU the
JAX index builds no mirror, so the parity runs take the gather route in
the port too (``SMQTK_TPU_NO_MRPT_MIRROR=1``).

Tolerances: the exact re-ranks of the two packages sum the same f32
squares in different orders (``EXACT_TOL``); projections agree within
1e-5 of their largest magnitude. Rows may differ only between candidates
tied with the k-th distance within the same tolerance.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import mrpt as jax_index
from smqtk_indexing_tpu.ops import mrpt as jax_mrpt
from smqtk_indexing_tpu.ops import sq8 as jax_sq8
from smqtk_indexing_tpu_torch.core.configuration import (
    configuration_test_helper,
)
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (
    MRPTNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.ops import mrpt
from tests.test_torch_helpers import assert_same_neighbours, elements_for

torch.set_num_threads(1)

EXACT_TOL = (1e-5, 1e-5)
SWITCH = "SMQTK_TPU_NO_MRPT_MIRROR"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _state(n=2048, d=64, t_count=4, depth=3, seed=0, clustered=True):
    """``tests/ops/test_mrpt_mirror.py:14-41``'s data and state, from the
    JAX projections: a dict of numpy arrays."""
    rng = np.random.default_rng(seed)
    if clustered:
        centers = rng.normal(size=(32, d)).astype(np.float32) * 4.0
        mat = (centers[rng.integers(0, 32, n)]
               + rng.normal(size=(n, d)).astype(np.float32) * 0.3)
    else:
        mat = rng.normal(size=(n, d)).astype(np.float32)
    d_pad = 128
    mat_p = np.zeros((n, d_pad), np.float32)
    mat_p[:, :d] = mat
    bases = np.zeros((t_count, d_pad, depth), np.float32)
    bases[:, :d, :] = rng.standard_normal((t_count, d, depth)) \
        .astype(np.float32)
    projs = np.asarray(jax_mrpt.project_all(jnp.asarray(mat_p),
                                            jnp.asarray(bases)))
    splits, leaf_table, offsets = jax_mrpt.build_trees(projs, depth)
    a, b = jax_sq8.sq8_train(mat_p)
    codes = jax_sq8.sq8_encode_np(mat_p, a, b)
    leaf_flat = leaf_table.reshape(-1).astype(np.int32)
    return dict(
        db=mat_p, sq=np.einsum("ij,ij->i", mat_p, mat_p).astype(np.float32),
        valid=np.ones(n, bool), bases=bases, splits=splits,
        leaf_table=leaf_table, leaf_flat=leaf_flat, offsets=offsets,
        mirror=codes[leaf_flat], a=a, b=b, depth=depth,
        leaf_max=int(np.diff(offsets).max()))


def _queries(state, b, seed, noise=0.05):
    rng = np.random.default_rng(seed)
    db = state["db"]
    return db[rng.integers(0, db.shape[0], b)] \
        + rng.normal(size=(b, db.shape[1])).astype(np.float32) * noise


def _gather_query(pkg, s, q, k):
    if pkg == "jax":
        d, r = jax_mrpt.mrpt_query(
            *(jnp.asarray(s[x]) for x in ("db", "sq", "valid", "bases",
                                          "splits", "leaf_table",
                                          "offsets")),
            jnp.asarray(q), k=k, depth=s["depth"], leaf_max=s["leaf_max"])
        return np.asarray(d), np.asarray(r)
    d, r = mrpt.mrpt_query(
        *(_t(s[x]) for x in ("db", "sq", "valid", "bases", "splits",
                             "leaf_table", "offsets")),
        _t(q), k=k, depth=s["depth"], leaf_max=s["leaf_max"])
    return d.numpy(), r.numpy()


def _mirror_query(pkg, s, q, k):
    names = ("db", "sq", "bases", "splits", "mirror", "a", "b", "leaf_flat",
             "offsets")
    if pkg == "jax":
        d, r = jax_mrpt.mrpt_query_mirror(
            *(jnp.asarray(s[x]) for x in names), jnp.asarray(q), k=k,
            depth=s["depth"], leaf_max=s["leaf_max"], interpret=True)
        return np.asarray(d), np.asarray(r)
    d, r = mrpt.mrpt_query_mirror(
        *(_t(s[x]) for x in names), _t(q), k=k, depth=s["depth"],
        leaf_max=s["leaf_max"])
    return d.numpy(), r.numpy()


# ---------------------------------------------------------------------------
# ops against the JAX package
# ---------------------------------------------------------------------------

def test_project_all_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(3000, 128)).astype(np.float32) * 5
    bases = rng.standard_normal((5, 128, 6)).astype(np.float32)
    out = mrpt.project_all(_t(x), _t(bases), chunk=512).numpy()
    assert out.shape == (3000, 5, 6) and out.dtype == np.float32
    # The JAX function takes a multiple of its chunk; the port's last
    # chunk may be ragged.
    ref = np.asarray(jax_mrpt.project_all(jnp.asarray(x[:2048]),
                                          jnp.asarray(bases), chunk=512))
    tol = 1e-5 * np.abs(ref).max()
    np.testing.assert_allclose(out[:2048], ref, rtol=0, atol=tol)
    np.testing.assert_allclose(
        out[2048:], np.einsum("nd,tdl->ntl", x[2048:].astype(np.float64),
                              bases), rtol=0, atol=tol)


@pytest.mark.parametrize("n,t_count,depth,seed,dups", [
    (100, 3, 4, 0, False), (2048, 4, 3, 1, False), (777, 2, 6, 2, False),
    (300, 3, 5, 3, True)])
def test_build_trees_bit_equal_to_jax(n, t_count, depth, seed, dups):
    rng = np.random.default_rng(seed)
    projs = rng.normal(size=(n, t_count, depth + 1)).astype(np.float32)
    if dups:
        # Repeated projection values: the same numpy partition breaks the
        # ties the same way in both.
        projs = np.round(projs * 2) / 2
    ref = jax_mrpt.build_trees(projs, depth)
    out = mrpt.build_trees(projs, depth)
    for r, o in zip(ref, out):
        assert r.dtype == o.dtype and np.array_equal(r, o)


def test_descend_leaves_equal():
    s = _state()
    q = _queries(s, 32, seed=4, noise=0.5)
    proj = np.einsum("bd,tdl->btl", q, s["bases"]).astype(np.float32)
    ref = np.asarray(jax_mrpt.descend_leaves(
        jnp.asarray(proj), jnp.asarray(s["splits"]), s["depth"]))
    out = mrpt.descend_leaves(_t(proj), _t(s["splits"]), s["depth"])
    assert out.dtype == torch.int64 and np.array_equal(out.numpy(), ref)


@pytest.mark.parametrize("b,k,stream,clustered", [
    (8, 8, False, True),      # the bf16 cohort arithmetic (B >= 8)
    (4, 8, False, True),      # full f32 below 8 queries
    (32, 16, True, False),    # chunked candidates with a running top-k
])
def test_mrpt_query_matches_jax(monkeypatch, b, k, stream, clustered):
    s = _state(clustered=clustered, seed=5)
    q = _queries(s, b, seed=6, noise=0.05 if clustered else 1.0)
    if stream:
        # Chunks of 2 * 128 candidates: the port streams, the JAX call
        # does not; the scores, and so the winners, are the same.
        monkeypatch.setattr(mrpt, "_STREAM_ELEMS", b * 128 * 2)
    d_ref, r_ref = _gather_query("jax", s, q, k)
    d_out, r_out = _gather_query("port", s, q, k)
    assert r_out.dtype == np.int64 and r_out.shape == (b, k)
    assert_same_neighbours(r_out, d_out, r_ref, d_ref, *EXACT_TOL)
    for row in r_out:
        assert len(set(row.tolist())) == k


@pytest.mark.parametrize("clustered,t_count,seed", [
    (True, 4, 0), (False, 4, 5), (True, 6, 9)])
def test_mrpt_query_mirror_matches_jax(clustered, t_count, seed):
    # The data and cases of tests/ops/test_mrpt_mirror.py.
    s = _state(clustered=clustered, t_count=t_count, seed=seed)
    q = _queries(s, 8, seed=seed + 1, noise=0.05)
    if not clustered:
        q = np.random.default_rng(2).normal(size=(8, 128)) \
            .astype(np.float32)
        q[:, 64:] = 0
    k = 16 if t_count == 6 else 8
    d_ref, r_ref = _mirror_query("jax", s, q, k)
    d_out, r_out = _mirror_query("port", s, q, k)
    assert_same_neighbours(r_out, d_out, r_ref, d_ref, *EXACT_TOL)
    for row in r_out:
        real = row[row >= 0]
        assert len(set(real.tolist())) == len(real)
    if clustered and k == 8:
        # Well-separated clusters at k=8: the mirror selects the gather
        # route's rows (at k=16 the SQ8 scores may reorder the tail).
        _, r_gather = _gather_query("port", s, q, k)
        assert np.array_equal(r_out, r_gather)


def test_mirror_windows_cover_each_leaf_once():
    s = _state()
    q = _queries(s, 8, seed=7)
    proj = np.einsum("bd,tdl->btl", q, s["bases"]).astype(np.float32)
    leaves = mrpt.descend_leaves(_t(proj), _t(s["splits"]), s["depth"])
    tn = s["mirror"].shape[0]
    starts, lo, hi = mrpt.mirror_windows(_t(s["offsets"]), leaves,
                                         tn // 4, tn, s["leaf_max"])
    assert starts.shape == (8, mrpt.PROBES_PER_STEP)
    assert int(starts.min()) >= 0 and int(starts.max()) <= tn - 512
    assert bool((starts % 32 == 0).all()) and bool((hi <= 512).all())
    off = s["offsets"]
    for bi in range(8):
        rows = sorted(r for p in range(starts.shape[1])
                      for r in range(int(starts[bi, p] + lo[bi, p]),
                                     int(starts[bi, p] + hi[bi, p])))
        want = sorted(t * (tn // 4) + r for t in range(4)
                      for r in range(off[leaves[bi, t]],
                                     off[leaves[bi, t] + 1]))
        assert rows == want


# ---------------------------------------------------------------------------
# the index against the JAX index, through its payload
# ---------------------------------------------------------------------------

N, D, N_Q, K = 1500, 24, 16, 10


def _index_data():
    rng = np.random.default_rng(11)
    centers = rng.normal(size=(24, D)).astype(np.float32) * 3
    pts = centers[rng.integers(0, 24, N + N_Q)] \
        + rng.normal(size=(N + N_Q, D)).astype(np.float32) * 0.5
    elems = [DescriptorMemoryElement(i, pts[i]) for i in range(N)]
    queries = [DescriptorMemoryElement(("q", i), pts[N + i])
               for i in range(N_Q)]
    return pts[:N], elems, queries


X, ELEMS, QUERIES = _index_data()


def _answers(index, queries=QUERIES, k=K):
    res = index.nn_many(elements_for(index, queries), k)
    return (np.array([[e.uuid() for e in r[0]] for r in res]),
            np.array([r[1] for r in res], dtype=np.float64))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_index_payload_parity_with_jax(monkeypatch, direction):
    monkeypatch.setenv(SWITCH, "1")
    kw = dict(num_trees=4, depth=4, random_seed=0)
    if direction == "jax_to_port":
        elem = JaxDataMemoryElement()
        ref = jax_index.MRPTNearestNeighborsIndex(index_element=elem, **kw)
        ref.build_index(elements_for(ref, ELEMS))
        port = MRPTNearestNeighborsIndex(
            index_element=DataMemoryElement(elem.get_bytes()),
            device="cpu", **kw)
    else:
        elem = DataMemoryElement()
        port = MRPTNearestNeighborsIndex(index_element=elem, device="cpu",
                                         **kw)
        port.build_index(ELEMS)
        ref = jax_index.MRPTNearestNeighborsIndex(
            index_element=JaxDataMemoryElement(elem.get_bytes()), **kw)
    assert port._mirror is None and port.count() == ref.count() == N
    for x in ("_splits_np", "_leaf_np", "_offsets_np", "_bases_np"):
        assert np.array_equal(getattr(port, x), getattr(ref, x))
    u_p, d_p = _answers(port)
    u_r, d_r = _answers(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)


def test_index_mirror_route_on_the_jax_payload():
    # On the CPU the port builds the mirror (the TPU routing) where the JAX
    # index does not: the same trees, SQ8 selection, exact distances.
    elem = JaxDataMemoryElement()
    ref = jax_index.MRPTNearestNeighborsIndex(
        index_element=elem, num_trees=4, depth=4, random_seed=0)
    ref.build_index(elements_for(ref, ELEMS))
    port = MRPTNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), num_trees=4,
        depth=4, random_seed=0, device="cpu")
    assert port._mirror is not None
    assert port._mirror.shape == (4 * 2048, 128)
    u_p, d_p = _answers(port)
    u_r, d_r = _answers(ref)
    recall = np.mean([len(set(a) & set(b)) / K for a, b in zip(u_p, u_r)])
    assert recall >= 0.95, recall
    for i in range(N_Q):
        exact = np.sqrt(((X[u_p[i]].astype(np.float64)
                          - QUERIES[i].vector()) ** 2).sum(1))
        np.testing.assert_allclose(d_p[i], exact, rtol=1e-5, atol=1e-5)
        assert len(set(u_p[i].tolist())) == K


# ---------------------------------------------------------------------------
# the reference behaviours, on the port alone
# ---------------------------------------------------------------------------

def _elem(uid, vec):
    return DescriptorMemoryElement(uid, np.asarray(vec, dtype=np.float32))


def _index(**kw):
    return MRPTNearestNeighborsIndex(device="cpu", **kw)


def test_balanced_partition_and_split_order():
    rng = np.random.default_rng(0)
    projs = rng.normal(size=(100, 3, 4)).astype(np.float32)
    splits, leaf_table, offsets = mrpt.build_trees(projs, 4)
    assert splits.shape == (3, 15) and leaf_table.shape == (3, 100)
    sizes = np.diff(offsets)
    assert offsets.shape == (17,) and sizes.min() >= 6 and sizes.max() <= 7
    for t in range(3):
        assert sorted(leaf_table[t]) == list(range(100))
    projs = rng.normal(size=(64, 1, 1)).astype(np.float32)
    splits, leaf_table, offsets = mrpt.build_trees(projs, 1)
    left = leaf_table[0][offsets[0]:offsets[1]]
    right = leaf_table[0][offsets[1]:offsets[2]]
    assert projs[left, 0, 0].max() <= splits[0, 0]
    assert projs[right, 0, 0].min() >= splits[0, 0]


def test_plugin_config_and_report():
    assert MRPTNearestNeighborsIndex in NearestNeighborsIndex.get_impls()
    i = _index(num_trees=5, depth=3, random_seed=7)
    for inst in configuration_test_helper(i):
        assert isinstance(inst, MRPTNearestNeighborsIndex)
        assert (inst.num_trees, inst.depth, inst.random_seed,
                inst.device) == (5, 3, 7, "cpu")
    with pytest.raises(ValueError, match="power of two"):
        _index(n_devices=3)


def test_usability_report_lists_the_switch(monkeypatch):
    monkeypatch.setenv(SWITCH, "1")
    report = MRPTNearestNeighborsIndex.usability_report()
    assert report["disabled_flags"] == [SWITCH] and report["degraded"]


@pytest.mark.parametrize("switch", [False, True])
def test_build_and_self_retrieval(monkeypatch, switch):
    if switch:
        monkeypatch.setenv(SWITCH, "1")
    rng = np.random.default_rng(0)
    elems = [_elem(j, rng.normal(size=16)) for j in range(256)]
    i = _index(num_trees=8, depth=3, random_seed=0)
    i.build_index(elems)
    # The switch is read at upload: a set one builds no mirror.
    assert (i._mirror is None) == switch
    assert i.count() == 256
    for j in (0, 100, 255):
        res, dists = i.nn(elems[j], 3)
        assert res[0].uuid() == j
        assert dists[0] == pytest.approx(0.0, abs=1e-5)
        assert list(dists) == sorted(dists)


def test_mirror_gate_budget_and_large_k(monkeypatch):
    rng = np.random.default_rng(1)
    elems = [_elem(j, rng.normal(size=8)) for j in range(600)]
    i = _index(num_trees=10, depth=1, random_seed=0)
    i.build_index(elems)
    assert i._mirror is not None and i.mirror_bytes() == 10 * 1024 * 128
    # k rounds to 128 > 64: the gather route, which still dedupes.
    spy = []
    monkeypatch.setattr(
        "smqtk_indexing_tpu_torch.models.nn_index.mrpt.mrpt_query",
        lambda *a, **kw: spy.append(kw["k"]) or mrpt.mrpt_query(*a, **kw))
    res, _ = i.nn(elems[0], 100)
    uids = [e.uuid() for e in res]
    assert spy == [128] and len(uids) == len(set(uids)) == 100
    monkeypatch.setattr(MRPTNearestNeighborsIndex, "MIRROR_BUDGET",
                        10 * 1024 * 128 - 1)
    i.build_index(elems)
    assert i._mirror is None


def test_no_duplicate_results():
    rng = np.random.default_rng(1)
    elems = [_elem(j, rng.normal(size=8)) for j in range(64)]
    i = _index(num_trees=10, depth=1, random_seed=0)
    i.build_index(elems)
    res, _ = i.nn(elems[0], 30)
    uids = [e.uuid() for e in res]
    assert len(uids) == len(set(uids)) == 30


def test_all_duplicate_points():
    elems = [_elem(j, [1.0, 2.0, 3.0, 4.0]) for j in range(20)]
    i = _index(num_trees=3, depth=2, random_seed=0)
    i.build_index(elems)
    res, dists = i.nn(elems[0], 5)
    assert len(res) == 5 and len({e.uuid() for e in res}) == 5
    assert all(d == pytest.approx(0.0, abs=1e-6) for d in dists)


def test_depth_clamp_warning():
    elems = [_elem(j, np.random.default_rng(j).normal(size=8))
             for j in range(8)]
    i = _index(num_trees=2, depth=10, random_seed=0)
    with pytest.warns(UserWarning, match="clamping"):
        i.build_index(elems)
    assert i._depth_eff == 3
    res, _ = i.nn(elems[2], 1)
    assert res[0].uuid() == 2


def test_under_fill_warnings():
    rng = np.random.default_rng(2)
    elems = [_elem(j, rng.normal(size=8)) for j in range(64)]
    i = _index(num_trees=1, depth=3, random_seed=0)
    i.build_index(elems)
    with pytest.warns(UserWarning, match="increase num_trees"):
        res, _ = i.nn(elems[0], 20)
    assert len(res) == 8
    with pytest.warns(UserWarning, match="only 64 are indexed"):
        i.nn(elems[0], 65)


def test_update_and_remove_rebuild():
    rng = np.random.default_rng(2)
    elems = [_elem(j, rng.normal(size=8)) for j in range(32)]
    i = _index(num_trees=6, depth=2, random_seed=0)
    i.build_index(elems[:16])
    i.update_index(elems[16:])
    assert i.count() == 32
    assert i.nn(elems[20], 1)[0][0].uuid() == 20
    i.remove_from_index([0, 1])
    assert i.count() == 30
    assert i.nn(elems[0], 1)[0][0].uuid() not in (0, 1)
    with pytest.raises(KeyError):
        i.remove_from_index([2, "bogus"])
    assert i.count() == 30
    i.remove_from_index([e.uuid() for e in elems[2:]])
    assert i.count() == 0
    fresh = _index(num_trees=2, depth=1, random_seed=0)
    fresh.update_index([_elem(0, [1, 2, 3, 4])])
    assert fresh.count() == 1


def test_read_only():
    i = _index(read_only=True)
    with pytest.raises(ReadOnlyError):
        i.build_index([_elem(0, [0, 0])])


def test_persistence_roundtrip():
    cache = DataMemoryElement()
    rng = np.random.default_rng(4)
    elems = [_elem(j, rng.normal(size=12)) for j in range(64)]
    i = _index(index_element=cache, num_trees=4, depth=2, random_seed=0)
    i.build_index(elems)
    assert not cache.is_empty()
    i2 = _index(index_element=cache, num_trees=4, depth=2, random_seed=0)
    assert i2.count() == 64 and i2._mirror is not None
    res, dists = i2.nn(elems[9], 1)
    assert res[0].uuid() == 9
    assert dists[0] == pytest.approx(0.0, abs=1e-5)


def test_colinear_ordering():
    elems = [_elem(j, [j + 1.0, 2.0 * (j + 1.0)]) for j in range(16)]
    i = _index(num_trees=4, depth=1, random_seed=0)
    i.build_index(elems)
    res, _ = i.nn(elems[0], 5)
    assert [e.uuid() for e in res] == [0, 1, 2, 3, 4]


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        MRPTNearestNeighborsIndex()
