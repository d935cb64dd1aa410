"""
The port's OPQ rotation training (``smqtk_indexing_tpu_torch/ops/opq.py``)
against the JAX package's (``ops/opq.py``) on the CPU, from the same numpy
rows: the host-side transforms are identical, and the trained rotation is
orthogonal and quantizes about as well as the JAX package's (a training
run, so not bit for bit).
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops import opq as jopq
from smqtk_indexing_tpu_torch.ops import opq, pq

torch.set_num_threads(1)


def _correlated(n, d=128, rank=8, seed=0):
    """Rows of a rank-``rank`` latent mixture mixed into ``d`` dims (the
    regime where a rotation matters)."""
    rng = np.random.default_rng(seed)
    lat = rng.random((64, rank), dtype=np.float32)
    w = rng.standard_normal((rank, d)).astype(np.float32) / np.sqrt(rank)
    z = lat[rng.integers(0, 64, size=n)] \
        + rng.normal(size=(n, rank)).astype(np.float32) / 12
    return (z @ w + rng.normal(size=(n, d)).astype(np.float32) / 50) \
        .astype(np.float32)


def test_compose_transform_and_eig_init_match_jax():
    rows = _correlated(2000)
    perm = pq.pq_perm(128, 16)
    rot = np.linalg.qr(np.random.default_rng(1).normal(size=(128, 128)))[0] \
        .astype(np.float32)
    t = opq.compose_transform(perm, rot)
    np.testing.assert_array_equal(t, jopq.compose_transform(perm, rot))
    # q @ T == q[:, perm] @ rot: the interleave then the rotation.
    np.testing.assert_allclose(rows[:5] @ t, rows[:5, perm] @ rot,
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(opq.eig_alloc_init(rows, 16),
                                  jopq.eig_alloc_init(rows, 16))


def _recon_error(x, rot, cb):
    xr = x @ rot
    return float(((xr - pq.pq_decode_np(pq.pq_encode_np(xr, cb), cb)) ** 2)
                 .sum())


@pytest.mark.parametrize("init", ["identity", "eig"])
def test_opq_train_is_orthogonal_and_matches_jax_error(init):
    rows = _correlated(3000, seed=2)
    kw = dict(n_iter=4, sample=2048, inner_kmeans_iter=2,
              final_kmeans_iter=4, init=init)
    rot_p, cb_p = opq.opq_train(rows, 16, **kw)
    rot_j, cb_j = jopq.opq_train(rows, 16, **kw)
    assert rot_p.shape == (128, 128) and cb_p.shape == (16, 256, 8)
    np.testing.assert_allclose(rot_p @ rot_p.T, np.eye(128), atol=1e-5)
    # The same sample (one numpy draw), so the errors compare directly.
    sample = rows[np.random.default_rng(0).choice(3000, 2048,
                                                  replace=False)]
    err_p = _recon_error(sample, rot_p, cb_p)
    err_j = _recon_error(sample, rot_j, cb_j)
    assert abs(err_p - err_j) <= 0.05 * err_j
    # And the rotation earns its keep over plain PQ on this data.
    assert err_p < _recon_error(sample, np.eye(128, dtype=np.float32),
                                pq.pq_train(sample, 16, n_iter=4))


def test_opq_train_rejects_bad_arguments():
    rows = _correlated(300)
    with pytest.raises(ValueError, match="divisible"):
        opq.opq_train(rows[:, :100], 16)
    with pytest.raises(ValueError, match="init"):
        opq.opq_train(rows, 16, init="pca")
