"""
The port's streamed scan (``smqtk_indexing_tpu_torch/ops/scan.py``)
against the JAX package's ``ops/scan.py``, for all five metrics, with the
same inputs made by numpy from a seed.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops import scan as jax_scan
from smqtk_indexing_tpu_torch.ops import scan
from tests.test_torch_helpers import assert_same_neighbours

torch.set_num_threads(1)

#: Both sides compute the same f32 formulas and differ only in summation
#: order.
RTOL = 1e-5
ATOL = 1e-5


def _inputs(n, d, b, seed):
    # Non-negative histogram-like data: hik and chi_square are defined
    # on it, and the matmul metrics are indifferent.
    rng = np.random.default_rng(seed)
    db = rng.random((n, d), dtype=np.float32)
    q = rng.random((b, d), dtype=np.float32)
    valid = rng.random(n) > 0.05
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    return db, sq, np.sqrt(sq), valid, q


@pytest.mark.parametrize("metric", scan.METRICS)
def test_flat_topk_matches_jax(metric):
    n, d, b, k, chunk = 2048, 32, 8, 7, 512
    db, sq, norm, valid, q = _inputs(n, d, b, seed=0)
    d_ref, r_ref = jax_scan.flat_topk(
        jnp.asarray(db), jnp.asarray(sq), jnp.asarray(norm),
        jnp.asarray(valid), jnp.asarray(q), k=k, metric=metric, chunk=chunk)
    d_port, r_port = scan.flat_topk(
        *(torch.from_numpy(a) for a in (db, sq, norm, valid, q)),
        k=k, metric=metric, chunk=chunk)
    assert d_port.shape == r_port.shape == (b, k)
    assert valid[r_port.numpy()].all()
    assert_same_neighbours(r_port, d_port, r_ref, d_ref, RTOL, ATOL)


@pytest.mark.parametrize("metric", scan.METRICS)
def test_pad_to_k_contract_past_live_rows(metric):
    # Fewer live rows than k: the tail is +inf / -1.
    n, d, b, k = 1024, 16, 4, 6
    db, sq, norm, _, q = _inputs(n, d, b, seed=1)
    valid = np.zeros(n, dtype=bool)
    valid[[3, 500, 1000]] = True
    d_port, r_port = scan.flat_topk(
        *(torch.from_numpy(a) for a in (db, sq, norm, valid, q)),
        k=k, metric=metric)
    d_ref, r_ref = jax_scan.flat_topk(
        jnp.asarray(db), jnp.asarray(sq), jnp.asarray(norm),
        jnp.asarray(valid), jnp.asarray(q), k=k, metric=metric)
    assert (r_port[:, 3:] == -1).all()
    assert torch.isinf(d_port[:, 3:]).all()
    # The JAX scan's single-block path (n <= chunk) leaves dead rows' ids
    # in the tail instead of -1, and its cosine maps the tail to distance
    # 2; its stores never show either (they trim to the live count). The
    # port keeps the documented +inf / -1.
    np.testing.assert_array_equal(r_port.numpy()[:, :3],
                                  np.asarray(r_ref)[:, :3])
    np.testing.assert_allclose(d_port.numpy()[:, :3],
                               np.asarray(d_ref)[:, :3], rtol=RTOL,
                               atol=ATOL)


def test_pad_to_k_matches_jax():
    rng = np.random.default_rng(2)
    dists = np.sort(rng.random((3, 4)).astype(np.float32), axis=1)
    rows = rng.integers(0, 100, size=(3, 4)).astype(np.int32)
    for k in (2, 4, 7):
        d_ref, r_ref = jax_scan.pad_to_k(jnp.asarray(dists),
                                         jnp.asarray(rows), k)
        d_port, r_port = scan.pad_to_k(torch.from_numpy(dists),
                                       torch.from_numpy(rows), k)
        np.testing.assert_array_equal(d_port.numpy(), np.asarray(d_ref))
        np.testing.assert_array_equal(r_port.numpy(), np.asarray(r_ref))


@pytest.mark.parametrize("metric", scan.METRICS)
def test_rerank_exact_matches_jax(metric):
    rng = np.random.default_rng(3)
    q = rng.random(24, dtype=np.float32)
    cand = rng.random((50, 24), dtype=np.float32)
    ref = np.asarray(jax_scan.rerank_exact(metric, jnp.asarray(q),
                                           jnp.asarray(cand)))
    out = scan.rerank_exact(metric, torch.from_numpy(q),
                            torch.from_numpy(cand)).numpy()
    np.testing.assert_allclose(out, ref, rtol=RTOL, atol=ATOL)


def test_flat_topk_rejects_unknown_metric():
    db, sq, norm, valid, q = _inputs(256, 8, 2, seed=4)
    with pytest.raises(ValueError, match="Unknown metric"):
        scan.flat_topk(*(torch.from_numpy(a)
                         for a in (db, sq, norm, valid, q)),
                       k=3, metric="manhattan")
