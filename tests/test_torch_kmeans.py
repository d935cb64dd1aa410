"""
The port's k-means (``smqtk_indexing_tpu_torch/ops/kmeans.py``) against
the JAX package's (``ops/kmeans.py``) on the CPU, from the same numpy
inputs and the same init.
"""
import numpy as np
import torch

import jax.numpy as jnp

from smqtk_indexing_tpu.ops import kmeans as jkm
from smqtk_indexing_tpu_torch.ops import kmeans

torch.set_num_threads(1)

#: Centroids, port vs JAX: per-cell means of the same rows, summed in
#: another order.
RTOL = 1e-5


def _separated(n=2400, c=12, d=96, seed=0):
    """Rows around ``c`` far-apart centres, and an init of one row from
    each cluster: no row is near a tie between two centroids."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(c, d)).astype(np.float32) * 10.0
    lab = np.concatenate([np.arange(c), rng.integers(0, c, size=n - c)])
    x = (centres[lab] + rng.normal(size=(n, d)) * 0.5).astype(np.float32)
    return x, x[:c].copy()


def _both(x, valid, init, n_iter, chunk=512):
    c_p, a_p = kmeans.kmeans_lloyd(torch.from_numpy(x),
                                   torch.from_numpy(valid),
                                   torch.from_numpy(init), n_iter=n_iter,
                                   chunk=chunk)
    c_j, a_j = jkm.kmeans_lloyd(jnp.asarray(x), jnp.asarray(valid),
                                jnp.asarray(init), n_iter=n_iter,
                                chunk=chunk)
    return c_p.numpy(), a_p.numpy(), np.asarray(c_j), np.asarray(a_j)


def test_lloyd_and_assign_match_jax():
    x, init = _separated()
    valid = np.ones(x.shape[0], bool)
    valid[-100:] = False                         # padding rows
    c_p, a_p, c_j, a_j = _both(x, valid, init, n_iter=6)
    np.testing.assert_array_equal(a_p, a_j)
    np.testing.assert_allclose(c_p, c_j, rtol=RTOL, atol=1e-4)
    a2_p = kmeans.kmeans_assign(torch.from_numpy(x), torch.from_numpy(c_j),
                                chunk=700).numpy()
    a2_j = np.asarray(jkm.kmeans_assign(jnp.asarray(x), jnp.asarray(c_j)))
    np.testing.assert_array_equal(a2_p, a2_j)


def test_empty_cell_split_matches_jax():
    # Two inits at one point: the second cell wins no row (ties go to the
    # lower id), is empty, and adopts a perturbed copy of the largest
    # cell's centroid.
    x, init = _separated(seed=2)
    init[7] = init[3]
    valid = np.ones(x.shape[0], bool)
    first = kmeans.kmeans_assign(torch.from_numpy(x),
                                 torch.from_numpy(init)).numpy()
    counts = np.bincount(first, minlength=12)
    assert counts[7] == 0
    donor = int(np.argmax(counts))
    c_p, a_p, c_j, a_j = _both(x, valid, init, n_iter=1)
    np.testing.assert_allclose(c_p, c_j, rtol=RTOL, atol=1e-4)
    assert not np.array_equal(c_p[7], c_p[donor])
    np.testing.assert_allclose(c_p[7], c_p[donor], rtol=2e-4, atol=1e-6)
    # The split cell and its donor are 1e-4 apart, so the final assignment
    # between those two is a near tie either package may break its own
    # way; every other row agrees.
    pair = np.isin(a_j, [7, donor])
    np.testing.assert_array_equal(a_p[~pair], a_j[~pair])
    assert np.isin(a_p[pair], [7, donor]).all()
