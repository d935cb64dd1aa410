"""
The port's PQ codec (``smqtk_indexing_tpu_torch/ops/pq.py``, the batched
Lloyd of ``ops/kmeans.py``) and the flat PQ scan ``pq_topk`` against the
JAX package's (``ops/pq.py``) and against float64, on the CPU. Inputs are
numpy arrays made from a seed: d=96 rows padded to 128 dims, M in
{8, 12, 16}, at most 8,192 rows, B <= 8.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smqtk_indexing_tpu.ops import pq as jpq
from smqtk_indexing_tpu_torch.ops import kmeans, pq
from tests.test_torch_helpers import assert_same_neighbours

torch.set_num_threads(1)

D, D_PAD, C = 96, 128, 16
#: Codebooks and stats, port vs JAX: the same f32 sums in another order.
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _separated(n, m, dsub, seed):
    """Rows whose every subspace is one of 256 far-apart codewords plus a
    little noise, the codewords, and each row's codes: no row is near a
    tie between two codewords."""
    rng = np.random.default_rng(seed)
    words = rng.normal(size=(m, 256, dsub)).astype(np.float32) * 10.0
    codes = rng.integers(0, 256, size=(n, m))
    used = min(n, 256)
    codes[:used] = np.arange(used)[:, None]        # every codeword used
    rows = words[np.arange(m), codes] \
        + rng.normal(size=(n, m, dsub)).astype(np.float32) * 0.05
    return rows.reshape(n, m * dsub).astype(np.float32), words, \
        codes.astype(np.uint8)


# ---------------------------------------------------------------------------
# The codec
# ---------------------------------------------------------------------------

def test_batched_lloyd_equals_separate_runs_with_an_empty_cell():
    m, n, dsub = 4, 1500, 8
    rows, words, _ = _separated(n, m, dsub, seed=0)
    x = rows.reshape(n, m, dsub).transpose(1, 0, 2).copy()
    init = x[:, :256].copy()
    init[2, 9] = init[2, 4]          # two inits at one point: cell 9 empty
    batched = kmeans.kmeans_lloyd_batched(_t(x), _t(init), n_iter=3).numpy()
    for mi in range(m):
        one, _ = kmeans.kmeans_lloyd(_t(x[mi]), torch.ones(n, dtype=bool),
                                     _t(init[mi]), n_iter=3)
        np.testing.assert_allclose(batched[mi], one.numpy(), rtol=RTOL,
                                   atol=1e-5)
    # The empty cell took a perturbed copy of a donor centroid.
    assert not np.allclose(batched[2, 9], init[2, 9])


@pytest.mark.parametrize("n", [200, 3000])
def test_pq_train_init_draw_matches_jax(n):
    # n_iter=0 returns the init: 256 rows drawn by numpy, padded with
    # duplicates when n < 256.
    rows, _, _ = _separated(n, 8, 12, seed=1)
    np.testing.assert_array_equal(pq.pq_train(rows, 8, n_iter=0, seed=3),
                                  jpq.pq_train(rows, 8, n_iter=0, seed=3))


def test_pq_train_and_encode_match_jax_on_separated_subspaces():
    m, dsub = 8, 12
    rows, words, codes = _separated(3000, m, dsub, seed=2)
    init = words + 0.01                  # one init in each codeword's cell
    cb_p = pq.pq_train(rows, m, n_iter=5, init=init)
    cb_j = jpq.pq_train(rows, m, n_iter=5, init=init)
    np.testing.assert_allclose(cb_p, cb_j, rtol=RTOL, atol=1e-6)
    enc_p = pq.pq_encode_np(rows, cb_j)
    np.testing.assert_array_equal(enc_p, jpq.pq_encode_np(rows, cb_j))
    np.testing.assert_array_equal(enc_p, codes)
    assert enc_p.dtype == np.uint8 and (enc_p >= 128).any()
    np.testing.assert_array_equal(pq.pq_decode_np(enc_p, cb_j),
                                  jpq.pq_decode_np(enc_p, cb_j))


@pytest.mark.parametrize("m", [8, 12, 16])
def test_codec_grid_matches_jax(m):
    d_codec = pq.pq_codec_dim(D_PAD, m)
    assert d_codec == jpq.pq_codec_dim(D_PAD, m)
    assert d_codec == {8: 128, 12: 132, 16: 128}[m]
    perm = pq.pq_perm(d_codec, m)
    np.testing.assert_array_equal(
        perm, np.argsort(np.arange(d_codec) % m, kind="stable"))
    rows = np.random.default_rng(m).normal(size=(5, D_PAD)) \
        .astype(np.float32)
    np.testing.assert_array_equal(pq.pq_prep_queries(rows, perm),
                                  jpq.pq_prep_queries(rows, perm))
    # The device transform gathers the same dims.
    np.testing.assert_array_equal(
        pq.pq_transform_queries(_t(rows), _t(perm)).numpy(),
        jpq.pq_prep_queries(rows, perm))


def _codes_and_books(n, m, dsub, seed):
    rng = np.random.default_rng(seed)
    cb = rng.normal(size=(m, 256, dsub)).astype(np.float32)
    codes = rng.integers(0, 256, size=(n, m)).astype(np.uint8)
    return codes, cb


def test_dequant_and_row_stats_match_jax_and_float64():
    codes, cb = _codes_and_books(3000, 12, 11, seed=4)
    x_p = pq._dequant(_t(codes), _t(cb)).numpy()
    x_j = np.asarray(jpq._dequant(jnp.asarray(codes), jnp.asarray(cb),
                                  dtype=jnp.float32))
    np.testing.assert_array_equal(x_p, x_j)
    np.testing.assert_array_equal(x_p, jpq.pq_decode_np(codes, cb))
    # int8 tensors holding the uint8 bit pattern decode the same.
    np.testing.assert_array_equal(
        pq._dequant(_t(codes.view(np.int8)), _t(cb)).numpy(), x_p)
    s2_p = pq.pq_row_stats(_t(codes), _t(cb)).numpy()
    s2_j = np.asarray(jpq.pq_row_stats(jnp.asarray(codes), jnp.asarray(cb)))
    np.testing.assert_allclose(s2_p, s2_j, rtol=RTOL)
    x64 = x_p.astype(np.float64)
    np.testing.assert_allclose(s2_p, (x64 * x64).sum(1), rtol=RTOL)
    cents = np.random.default_rng(5).normal(size=(C, 132)) \
        .astype(np.float32)
    row2list = np.random.default_rng(6).integers(0, C, 3000) \
        .astype(np.int32)
    r_p = pq.pq_residual_stats(_t(codes), _t(cb), _t(cents), _t(row2list),
                               chunk=1024).numpy()
    r_j = np.asarray(jpq.pq_residual_stats(
        jnp.asarray(codes), jnp.asarray(cb), jnp.asarray(cents),
        jnp.asarray(row2list), chunk=1000))
    np.testing.assert_allclose(r_p, r_j, rtol=RTOL)
    full = x64 + cents[row2list]
    np.testing.assert_allclose(r_p, (full * full).sum(1), rtol=RTOL)


def _clustered(n, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(C, D)).astype(np.float32) * 2.0
    assigns = np.sort(rng.integers(0, C, size=n)).astype(np.int32)
    rows = centres[assigns] + rng.normal(size=(n, D)).astype(np.float32) \
        * 0.4
    return rows.astype(np.float32), assigns


def test_store_builds_match_jax(monkeypatch):
    rows, assigns = _clustered(2500, seed=7)
    valid = np.random.default_rng(8).random(2500) >= 0.05
    # Raw PQ: with the codec given, the same codes and stats.
    codec = jpq.pq_build_store(rows, valid, 4096, D_PAD, 16)
    port = pq.pq_build_store(rows, valid, 4096, D_PAD, 16, "cpu",
                             codec=codec[:3])
    np.testing.assert_array_equal(port[4].numpy(), np.asarray(codec[4]))
    np.testing.assert_allclose(port[5].numpy(), np.asarray(codec[5]),
                               rtol=RTOL)
    # Residual PQ: the codebooks the JAX build trained, through the
    # port's trainer, which must see the same live residuals.
    cents = np.stack([rows[assigns == i].mean(0) for i in range(C)])
    cents_pad = np.zeros((C, D_PAD), np.float32)
    cents_pad[:, :D] = cents
    ref = jpq.pq_residual_build_store(rows, valid, 4096, D_PAD, 16,
                                      cents_pad, assigns)
    seen = []

    def trained(live, m, **kw):
        seen.append(live)
        return ref[2]
    monkeypatch.setattr(pq, "pq_train", trained)
    out = pq.pq_residual_build_store(rows, valid, 4096, D_PAD, 16,
                                     cents_pad, assigns, "cpu")
    res = jpq.pq_prep_queries(rows, ref[0]) \
        - jpq.pq_prep_queries(cents_pad, ref[0])[assigns]
    np.testing.assert_array_equal(seen[0], res[valid])
    np.testing.assert_array_equal(out[0], ref[0])
    np.testing.assert_array_equal(out[4].numpy(), np.asarray(ref[4]))
    np.testing.assert_allclose(out[5].numpy(), np.asarray(ref[5]),
                               rtol=RTOL)
    np.testing.assert_array_equal(out[6], ref[6])
    np.testing.assert_array_equal(out[7].numpy(), np.asarray(ref[7]))


def _oracle(x64, q64, valid, metric, k):
    """Float64 top-k ids and distances over reconstructions."""
    if metric == "euclidean":
        dist = np.sqrt(((q64[:, None] - x64[None]) ** 2).sum(-1))
    elif metric == "inner_product":
        dist = -(q64 @ x64.T)
    elif metric == "cosine":
        sim = (q64 @ x64.T) / np.linalg.norm(q64, axis=1)[:, None] \
            / np.linalg.norm(x64, axis=1)[None]
        dist = 2.0 * np.arccos(np.clip(sim, -1, 1)) / np.pi
    else:
        dist = 1.0 - np.minimum(q64[:, None], x64[None]).sum(-1)
    dist[:, ~valid] = np.inf
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(dist, ids, 1)


@pytest.mark.parametrize("n,chunk", [(2048, 4096), (8192, 2048)])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine",
                                    "hik"])
def test_pq_topk_matches_float64_and_jax(metric, n, chunk):
    # n <= chunk scores every row; n > chunk streams segment minima.
    codes, cb = _codes_and_books(n, 8, 16, seed=9)
    if metric == "hik":
        cb = np.abs(cb) * 0.1
    valid = np.random.default_rng(10).random(n) >= 0.05
    x64 = jpq.pq_decode_np(codes, cb).astype(np.float64)
    s2 = (x64 * x64).sum(1).astype(np.float32)
    q = x64[:6].astype(np.float32) + 0.05
    k = 8
    d_p, r_p = pq.pq_topk(_t(codes), _t(cb), _t(s2), _t(valid), _t(q), k=k,
                          metric=metric, chunk=chunk)
    ids, dist = _oracle(x64, q.astype(np.float64), valid, metric, k)
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), ids, dist, rtol=1e-5,
                           atol=1e-5)
    # The JAX package ranks with bf16 codebooks and products: at the k
    # boundary it may keep another near tie; the rows both return agree.
    d_j, r_j = jpq.pq_topk(jnp.asarray(codes), jnp.asarray(cb),
                           jnp.asarray(s2), jnp.asarray(valid),
                           jnp.asarray(q), k=k, metric=metric, chunk=chunk)
    d_j, r_j = np.asarray(d_j), np.asarray(r_j)
    for i in range(q.shape[0]):
        common = set(r_p[i].tolist()) & set(r_j[i].tolist())
        assert len(common) >= k - 2
        lp = dict(zip(r_p[i].tolist(), d_p[i].tolist()))
        lj = dict(zip(r_j[i].tolist(), d_j[i].tolist()))
        for u in common:
            assert abs(lp[u] - lj[u]) <= 1e-5 * max(1.0, abs(lj[u]))
