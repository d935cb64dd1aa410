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


def test_cell_sums_match_float64_and_repeat_bit_for_bit():
    # Rows spread over six decades, a padding key and an empty cell: each
    # cell's fixed-point sum is the float64 segment sum to 1e-6 of the
    # cell's sum of magnitudes, and a second call gives the same bits.
    rng = np.random.default_rng(5)
    n, d, c = 5000, 24, 37
    x = (rng.normal(size=(n, d)) * 10.0 ** rng.integers(-3, 3, size=(1, d))
         ).astype(np.float32)
    keys = rng.integers(0, c + 1, size=n)           # key c: padding
    keys[keys == 11] = 12                           # cell 11 stays empty
    xt = torch.from_numpy(x)
    scale = kmeans.fixed_point_scale(xt.abs().amax(0), n)
    runs = [kmeans.cell_sums(torch.from_numpy(keys),
                             kmeans.to_fixed(xt, scale), c)
            for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    sums, counts = runs[0]
    want = np.zeros((c, d))
    mag = np.zeros((c, d))
    np.add.at(want, keys[keys < c], x[keys < c].astype(np.float64))
    np.add.at(mag, keys[keys < c], np.abs(x[keys < c]).astype(np.float64))
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(keys, minlength=c + 1)[:c])
    got = sums.double().numpy() / scale.numpy()
    assert np.all(np.abs(got - want) <= 1e-6 * mag)
    assert counts[11] == 0 and not sums[11].any()
    means = kmeans.cell_means(sums, counts, scale,
                              torch.full((c, d), 7.0)).numpy()
    live = counts.numpy() > 0
    np.testing.assert_allclose(
        means[live], (want[live] / counts.numpy()[live, None]),
        rtol=1e-6, atol=0)
    assert (means[11] == 7.0).all()


def test_lloyd_repeats_bit_for_bit_in_any_blocking():
    # Integer sums do not depend on the order of the additions: another
    # block size gives the same centroids bit for bit.
    x, init = _separated(seed=4)
    valid = torch.ones(x.shape[0], dtype=torch.bool)
    out = [kmeans.kmeans_lloyd(torch.from_numpy(x), valid,
                               torch.from_numpy(init), n_iter=4,
                               chunk=chunk) for chunk in (512, 512, 333)]
    for c, a in out[1:]:
        assert torch.equal(c, out[0][0]) and torch.equal(a, out[0][1])


def test_batched_prefix_sums_stay_inside_int64(monkeypatch):
    # Sixteen problems of 1,024 rows, every value positive and near its
    # column's largest magnitude: a prefix sum over all problems' rows
    # at once would pass 2^63. Each int64 prefix must stay inside it (sum
    # of magnitudes as the bound), and the centroids are the float64
    # means of their clusters.
    rng = np.random.default_rng(9)
    m, n, d, c = 16, 1024, 4, 8
    lab = np.concatenate([np.arange(c), rng.integers(0, c, size=n - c)])
    x = (100.0 + 10.0 * lab[None, :, None]
         + rng.uniform(0.0, 1.0, size=(m, n, d))).astype(np.float32)
    init = x[:, :c].copy()
    seen = []
    cumsum = torch.cumsum

    def checked(t, dim, **kw):
        if t.dtype == torch.int64:
            seen.append(float(t.double().abs().sum(dim).max()))
        return cumsum(t, dim, **kw)
    monkeypatch.setattr(torch, "cumsum", checked)
    got = kmeans.kmeans_lloyd_batched(torch.from_numpy(x),
                                      torch.from_numpy(init), n_iter=2)
    assert seen and max(seen) < 2.0 ** 63
    want = np.stack([[x[p, lab == k].astype(np.float64).mean(0)
                      for k in range(c)] for p in range(m)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
