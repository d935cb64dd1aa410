"""
The port's multi-device layer (``smqtk_indexing_tpu_torch/parallel/``)
against the JAX package's, function by function, on the CPU. The port's
meshes put every shard on the CPU (``make_mesh(n, device="cpu")``); the
JAX meshes take tier-1's 8 virtual CPU devices. Inputs are numpy arrays
made from a seed and fed to both. Meshes: 1-D at 2, 4 and 8 shards, and
the 2-D (dcn=2, shard=4) mesh.

Tolerances: the per-shard scans compute the same exact f32 formulas in
other orders, so distances agree within 1e-5 (relative and absolute),
Hamming distances and the layout tables exactly; rows agree except for
near ties at the k-th place (``assert_same_neighbours``), and exactly
where ties are planted across shards (the merge's tie order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.parallel import mesh as jax_mesh
from smqtk_indexing_tpu.parallel import sharded_scan as jax_ss
from smqtk_indexing_tpu.parallel.sharded_ivf import shard_csr as jax_csr
from smqtk_indexing_tpu.parallel.sharded_ivf_code import (
    shard_tiled_layout as jax_tiled_layout,
)
from smqtk_indexing_tpu.parallel.sharded_mrpt import (
    shard_leaf_tables as jax_leaf_tables,
)
from smqtk_indexing_tpu_torch.ops import pq
from smqtk_indexing_tpu_torch.ops.sq8 import sq8_build_store
from smqtk_indexing_tpu_torch.parallel import mesh, sharded_scan
from smqtk_indexing_tpu_torch.parallel.sharded_ivf import shard_csr
from smqtk_indexing_tpu_torch.parallel.sharded_ivf_code import (
    shard_tiled_layout,
)
from smqtk_indexing_tpu_torch.parallel.sharded_mrpt import shard_leaf_tables
from smqtk_indexing_tpu_torch.utils.bits import pack_bit_vectors_u32
from tests.test_torch_helpers import assert_same_neighbours

torch.set_num_threads(1)

TOL = (1e-5, 1e-5)
#: (n_devices, dcn): the 1-D meshes and the 2-D one.
MESHES = [(2, 1), (4, 1), (8, 1), (8, 2)]
MESH_IDS = ["s2", "s4", "s8", "dcn2x4"]


def _meshes(n, dcn):
    return (mesh.make_mesh(n, device="cpu", dcn=dcn),
            jax_mesh.make_mesh(n, dcn=dcn))


def _flat_inputs(n, d, b, seed, dead=True):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n, d)).astype(np.float32)
    q = rng.normal(size=(b, d)).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    valid = rng.random(n) > 0.1 if dead else np.ones(n, dtype=bool)
    return db, sq, np.sqrt(sq), valid, q


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,dcn", MESHES, ids=MESH_IDS)
def test_mesh_shape_matches_jax(n, dcn):
    pm, jm = _meshes(n, dcn)
    assert pm.axis_names == jm.axis_names
    assert pm.shape == dict(jm.shape)
    assert pm.size == jm.devices.size == n
    assert mesh.row_axes(pm) == jax_mesh.row_axes(jm)
    # Slices are contiguous runs of the slice-major shard order.
    assert sum(pm.slices(), []) == list(range(n))
    assert len(pm.slices()) == dcn


def _cards(monkeypatch, count):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: count > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)


@pytest.mark.parametrize("kw,match", [
    (dict(n_devices=4), "only 2 available"),
    (dict(n_devices=3, device="cpu"), "power of two"),
    (dict(n_devices=6, device="cpu"), "power of two"),
    (dict(n_devices=2), None),
    (dict(n_devices=4, device="cpu", dcn=3), "does not divide"),
    (dict(devices=["cuda:0", "cuda:2"]), "2 card"),
    (dict(devices=["cuda:1", "cuda:1"]), None),
], ids=["too_few_cards", "three", "six", "two_cards", "dcn", "no_card_2",
        "one_card_twice"])
def test_make_mesh_checks(monkeypatch, kw, match):
    # Two cards visible: too few raise, with no fallback to the CPU.
    _cards(monkeypatch, 2)
    if match is None:
        m = mesh.make_mesh(**kw)
        assert all(d.type == "cuda" for d in m.flat)
        assert m.flat == [torch.device("cuda", 0), torch.device("cuda", 1)] \
            or m.flat == [torch.device("cuda", 1)] * 2
        return
    with pytest.raises(ValueError, match=match):
        mesh.make_mesh(**kw)


def test_make_mesh_never_falls_back_without_a_card(monkeypatch):
    _cards(monkeypatch, 0)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.make_mesh(2)
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.mesh_for(2, "cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        mesh.mesh_for(2, ["cuda:0", "cuda:0"])
    # The JAX package builds its mesh on the CPU host platform here.
    assert jax_mesh.make_mesh(2).devices.flat[0].platform == "cpu"


def test_mesh_for_and_device_lists():
    assert mesh.mesh_for(None, "cpu") is None
    assert mesh.mesh_for(1, "cpu") is None
    m = mesh.mesh_for(4, ["cpu"] * 4)
    assert m.size == 4 and m.flat == [torch.device("cpu")] * 4
    with pytest.raises(ValueError, match="n_devices=2"):
        mesh.mesh_for(2, ["cpu"] * 4)
    assert mesh.device_config(["cpu", "cpu"]) == ["cpu", "cpu"]
    assert mesh.primary_device(["cpu", "cpu"]) == torch.device("cpu")


def test_shard_rows_and_replicate():
    pm = mesh.make_mesh(4, device="cpu")
    a = np.arange(24, dtype=np.float32).reshape(8, 3)
    parts = mesh.shard_rows(pm, a)
    assert [p.shape for p in parts] == [(2, 3)] * 4
    np.testing.assert_array_equal(torch.cat(parts).numpy(), a)
    cols = mesh.shard_rows(pm, a.T.copy(), axis=1)
    np.testing.assert_array_equal(torch.cat(cols, 1).numpy(), a.T)
    rep = mesh.replicate(pm, a)
    assert len(rep) == 4 and all(r is rep[0] for r in rep)
    assert mesh.replicate(pm, rep) is rep
    with pytest.raises(ValueError, match="not divisible"):
        mesh.shard_rows(pm, a[:6])


# ---------------------------------------------------------------------------
# the merge
# ---------------------------------------------------------------------------

def test_merge_topk_tie_order_matches_jax():
    # Integer distances: many ties inside and across shards.
    rng = np.random.default_rng(3)
    d = np.sort(rng.integers(0, 6, size=(4, 5, 8)).astype(np.float32), -1)
    r = rng.integers(0, 1000, size=(4, 5, 8)).astype(np.int32)
    dp, rp = sharded_scan._merge_topk(torch.from_numpy(d),
                                      torch.from_numpy(r), 8)
    dj, rj = jax_ss._merge_topk(jnp.asarray(d), jnp.asarray(r), 8)
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))


@pytest.mark.parametrize("n,dcn", MESHES, ids=MESH_IDS)
def test_planted_ties_across_shards(n, dcn):
    # Every shard holds the same rows: each distance appears once a
    # shard, so the k winners are ties across shards and must come out
    # lowest shard first (the JAX merge's order), on 2-D meshes too.
    pm, jm = _meshes(n, dcn)
    rng = np.random.default_rng(4)
    per, d, b, k = 16, 8, 4, 12
    block = rng.normal(size=(per, d)).astype(np.float32)
    db = np.tile(block, (n, 1))
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    valid = np.ones(n * per, dtype=bool)
    q = rng.normal(size=(b, d)).astype(np.float32)
    args_p = [mesh.shard_rows(pm, a) for a in (db, sq, np.sqrt(sq), valid)]
    args_j = [jax_mesh.shard_rows(jm, jnp.asarray(a))
              for a in (db, sq, np.sqrt(sq), valid)]
    dp, rp = sharded_scan.sharded_flat_topk(pm, *args_p, q, k=k)
    dj, rj = jax_ss.sharded_flat_topk(jm, *args_j,
                                      jax_mesh.replicate(jm, jnp.asarray(q)),
                                      k=k)
    np.testing.assert_allclose(dp.numpy(), np.asarray(dj), *TOL)
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))
    # Each tie group runs through the shards in order.
    assert (np.diff(rp.numpy()[:, :min(n, k)], axis=1) == per).all()


# ---------------------------------------------------------------------------
# the sharded scans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
@pytest.mark.parametrize("n,dcn", MESHES, ids=MESH_IDS)
def test_sharded_flat_topk_matches_jax(n, dcn, metric):
    pm, jm = _meshes(n, dcn)
    db, sq, nrm, valid, q = _flat_inputs(1024, 24, 6, seed=n + dcn)
    args_p = [mesh.shard_rows(pm, a) for a in (db, sq, nrm, valid)]
    args_j = [jax_mesh.shard_rows(jm, jnp.asarray(a))
              for a in (db, sq, nrm, valid)]
    dp, rp = sharded_scan.sharded_flat_topk(pm, *args_p, q, k=10,
                                            metric=metric)
    dj, rj = jax_ss.sharded_flat_topk(
        jm, *args_j, jax_mesh.replicate(jm, jnp.asarray(q)), k=10,
        metric=metric)
    assert rp.dtype == torch.int64 and dp.shape == (6, 10)
    assert_same_neighbours(rp.numpy(), dp.numpy(), np.asarray(rj),
                           np.asarray(dj), *TOL)


@pytest.mark.parametrize("n,dcn", [(8, 1), (8, 2)], ids=["s8", "dcn2x4"])
def test_shards_smaller_than_k(n, dcn):
    # 8 rows a shard, k = 16, some dead: shards pad with +inf / -1.
    pm, jm = _meshes(n, dcn)
    db, sq, nrm, valid, q = _flat_inputs(8 * n, 8, 3, seed=5)
    args_p = [mesh.shard_rows(pm, a) for a in (db, sq, nrm, valid)]
    args_j = [jax_mesh.shard_rows(jm, jnp.asarray(a))
              for a in (db, sq, nrm, valid)]
    dp, rp = sharded_scan.sharded_flat_topk(pm, *args_p, q, k=16)
    dj, rj = jax_ss.sharded_flat_topk(
        jm, *args_j, jax_mesh.replicate(jm, jnp.asarray(q)), k=16)
    assert_same_neighbours(rp.numpy(), dp.numpy(), np.asarray(rj),
                           np.asarray(dj), *TOL)
    short = sharded_scan.sharded_flat_topk(pm, *args_p, q, k=8 * n)
    live = int(valid.sum())
    assert (short[1].numpy()[:, live:] == -1).all()
    assert np.isinf(short[0].numpy()[:, live:]).all()


@pytest.mark.parametrize("n,dcn,rows", [(2, 1, 512), (4, 1, 512),
                                        (8, 1, 64), (8, 2, 512)],
                         ids=["s2", "s4", "s8_short", "dcn2x4"])
def test_sharded_hamming_topk_matches_jax(n, dcn, rows):
    # s8_short: 8 rows a shard, k = 16 (the 2**30 padding, merged in
    # float32).
    pm, jm = _meshes(n, dcn)
    rng = np.random.default_rng(6)
    codes = pack_bit_vectors_u32(rng.random((rows, 40)) > 0.5)
    valid = rng.random(rows) > 0.1
    q = pack_bit_vectors_u32(rng.random((5, 40)) > 0.5)
    dp, rp = sharded_scan.sharded_hamming_topk(
        pm, mesh.shard_rows(pm, codes.view(np.int32)),
        mesh.shard_rows(pm, valid), q.view(np.int32), k=16)
    dj, rj = jax_ss.sharded_hamming_topk(
        jm, jax_mesh.shard_rows(jm, jnp.asarray(codes)),
        jax_mesh.shard_rows(jm, jnp.asarray(valid)),
        jax_mesh.replicate(jm, jnp.asarray(q)), k=16)
    assert dp.dtype == torch.int32 and rp.dtype == torch.int32
    np.testing.assert_array_equal(dp.numpy(), np.asarray(dj))
    # Ties in distance go to the lower row, then the lower shard.
    np.testing.assert_array_equal(rp.numpy(), np.asarray(rj))


@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
@pytest.mark.parametrize("n,dcn", [(4, 1), (8, 2)], ids=["s4", "dcn2x4"])
def test_sharded_sq8_topk_matches_jax(n, dcn, metric):
    from smqtk_indexing_tpu.ops import sq8 as jsq8
    pm, jm = _meshes(n, dcn)
    db, _, _, valid, q = _flat_inputs(1024, 32, 6, seed=7)
    a, b, codes, s2, nrm = sq8_build_store(db, valid, 1024, 32, 32, "cpu")
    ja, jb, jcodes, js2, jnrm = jsq8.sq8_build_store(db, valid, 1024, 32,
                                                     32)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    va = valid.copy()
    dp, rp = sharded_scan.sharded_sq8_topk(
        pm, mesh.shard_rows(pm, codes), a, b, mesh.shard_rows(pm, s2),
        mesh.shard_rows(pm, nrm), mesh.shard_rows(pm, va), q, k=10,
        metric=metric)
    dj, rj = jax_ss.sharded_sq8_topk(
        jm, jax_mesh.shard_rows(jm, jcodes), jax_mesh.replicate(jm, ja),
        jax_mesh.replicate(jm, jb), jax_mesh.shard_rows(jm, js2),
        jax_mesh.shard_rows(jm, jnrm),
        jax_mesh.shard_rows(jm, jnp.asarray(va)),
        jax_mesh.replicate(jm, jnp.asarray(q)), k=10, metric=metric)
    assert_same_neighbours(rp.numpy(), dp.numpy(), np.asarray(rj),
                           np.asarray(dj), *TOL)


@pytest.mark.parametrize("n,dcn", [(2, 1), (8, 2)], ids=["s2", "dcn2x4"])
def test_sharded_pq_topk_matches_jax(n, dcn):
    pm, jm = _meshes(n, dcn)
    rng = np.random.default_rng(8)
    m, ds = 4, 8
    cb = rng.normal(size=(m, 256, ds)).astype(np.float32)
    codes = rng.integers(0, 256, size=(1024, m)).astype(np.uint8)
    valid = rng.random(1024) > 0.1
    q = rng.normal(size=(6, m * ds)).astype(np.float32)
    s2 = pq.pq_row_stats(torch.from_numpy(codes), torch.from_numpy(cb))
    dp, rp = sharded_scan.sharded_pq_topk(
        pm, mesh.shard_rows(pm, codes), cb, mesh.shard_rows(pm, s2),
        mesh.shard_rows(pm, valid), q, k=10)
    dj, rj = jax_ss.sharded_pq_topk(
        jm, jax_mesh.shard_rows(jm, jnp.asarray(codes)),
        jax_mesh.replicate(jm, jnp.asarray(cb)),
        jax_mesh.shard_rows(jm, jnp.asarray(s2.numpy())),
        jax_mesh.shard_rows(jm, jnp.asarray(valid)),
        jax_mesh.replicate(jm, jnp.asarray(q)), k=10)
    assert_same_neighbours(rp.numpy(), dp.numpy(), np.asarray(rj),
                           np.asarray(dj), *TOL)


@pytest.mark.parametrize("metric", ["euclidean", "cosine", "hik"])
@pytest.mark.parametrize("n,dcn", [(4, 1), (8, 2)], ids=["s4", "dcn2x4"])
def test_sharded_rerank_topk_matches_jax(n, dcn, metric):
    # 32 candidate slots over 8 shards: 4 a shard, k = 8 (short shards).
    pm, jm = _meshes(n, dcn)
    rng = np.random.default_rng(9)
    cand = np.abs(rng.normal(size=(5, 32, 12))).astype(np.float32)
    valid = rng.random((5, 32)) > 0.3
    q = np.abs(rng.normal(size=(5, 12))).astype(np.float32)
    dp, rp = sharded_scan.sharded_rerank_topk(
        pm, q, mesh.shard_rows(pm, cand, axis=1),
        mesh.shard_rows(pm, valid, axis=1), k=8, metric=metric)
    from jax.sharding import NamedSharding, PartitionSpec as P
    import jax
    axes = tuple(jm.axis_names)
    dj, rj = jax_ss.sharded_rerank_topk(
        jm, jax_mesh.replicate(jm, jnp.asarray(q)),
        jax.device_put(jnp.asarray(cand),
                       NamedSharding(jm, P(None, axes, None))),
        jax.device_put(jnp.asarray(valid), NamedSharding(jm, P(None, axes))),
        k=8, metric=metric)
    assert_same_neighbours(rp.numpy(), dp.numpy(), np.asarray(rj),
                           np.asarray(dj), *TOL)
    assert ((rp.numpy() == -1) == (np.asarray(rj) == -1)).all()


@pytest.mark.parametrize("n,dcn", [(4, 1), (8, 2)], ids=["s4", "dcn2x4"])
def test_sharded_kmeans_step_matches_jax(n, dcn):
    pm, jm = _meshes(n, dcn)
    rng = np.random.default_rng(10)
    x = rng.normal(size=(2048, 16)).astype(np.float32)
    valid = rng.random(2048) > 0.05
    c = x[rng.choice(2048, 32, replace=False)].copy()
    c[-1] = 100.0                                   # an empty cell
    cp, ap = sharded_scan.sharded_kmeans_step(
        pm, mesh.shard_rows(pm, x), mesh.shard_rows(pm, valid), c)
    cj, aj = jax_ss.sharded_kmeans_step(
        jm, jax_mesh.shard_rows(jm, jnp.asarray(x)),
        jax_mesh.shard_rows(jm, jnp.asarray(valid)),
        jax_mesh.replicate(jm, jnp.asarray(c)))
    np.testing.assert_array_equal(torch.cat(ap).numpy(), np.asarray(aj))
    np.testing.assert_allclose(cp.numpy(), np.asarray(cj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(cp.numpy()[-1], c[-1])
    # Partials add in shard order: the same call gives the same bits.
    again, _ = sharded_scan.sharded_kmeans_step(
        pm, mesh.shard_rows(pm, x), mesh.shard_rows(pm, valid), c)
    assert torch.equal(again, cp)


# ---------------------------------------------------------------------------
# the layout helpers (numpy on both sides: equal byte for byte)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_shards", [2, 4, 8])
def test_layout_helpers_match_jax(n_shards):
    rng = np.random.default_rng(11)
    lens = rng.integers(0, 900, size=24)
    offsets = np.concatenate([[0], np.cumsum(lens)[:-1]])
    n_rows = 32768
    for got, want in zip(shard_csr(offsets, lens, n_rows, n_shards),
                         jax_csr(offsets, lens, n_rows, n_shards)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
    for got, want in zip(
            shard_tiled_layout(lens, n_rows, n_shards, 24),
            jax_tiled_layout(lens, n_rows, n_shards, 24)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="TILE_ROWS"):
        shard_tiled_layout(np.array([10]), 4096 + 8, 2, 1)
    perm = np.stack([rng.permutation(3000) for _ in range(3)]).astype(
        np.int32)
    offs = np.array([0, 700, 1500, 2200, 3000])
    got = shard_leaf_tables(perm, offs, n_shards, 4096)
    want = jax_leaf_tables(perm, offs, n_shards, 4096)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g, w)
    assert got[2] == want[2]
