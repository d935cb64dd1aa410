"""
The port's fused scan (``smqtk_indexing_tpu_torch/ops/fused_scan.py``)
against the JAX package's ``ops/pallas_scan.py`` (interpret mode, exact
``precision="highest"``) and a float64 oracle. Inputs are made with numpy
from a seed and fed to both. On the CPU the port runs the kernel's plain
PyTorch version; the kernel itself is checked on the card by
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops import pallas_scan as jax_scan
from smqtk_indexing_tpu_torch.ops import fused_scan
from tests.test_torch_helpers import assert_same_neighbours, scan_inputs

torch.set_num_threads(1)

#: Stage-1 scores: both sides sum exact f32 (or bf16 x bf16) products in
#: f32, in different orders, so they differ by rounding only.
STAGE1_RTOL = 1e-5
#: Final distances: exact f32 formulas, summed in different orders.
DIST_RTOL = 1e-5


def _torch_db(db, dtype):
    return torch.from_numpy(db).to(getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_segment_minima_matches_jax(dtype):
    n, d, b = 8192, 128, 16
    db, sq, pen, q, _ = scan_inputs(n, d, b, seed=0)
    ref = np.asarray(jax_scan.segment_minima(
        jnp.asarray(db, dtype=getattr(jnp, dtype)).T,
        jnp.asarray(sq)[None, :], jnp.asarray(pen)[None, :],
        jnp.asarray(q), interpret=True, precision="highest"))
    before = fused_scan.LAUNCHES
    out = fused_scan.segment_minima(
        _torch_db(db, dtype), torch.from_numpy(sq), torch.from_numpy(pen),
        torch.from_numpy(q)).numpy()
    # The plain version on CPU tensors is not a kernel launch.
    assert fused_scan.LAUNCHES == before
    assert out.shape == (b, n // 128)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    assert np.isinf(out[:, 1]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=STAGE1_RTOL)


def test_segment_minima_rejects_bad_shapes_and_types():
    db = torch.zeros((200, 128))
    vec = torch.zeros(200)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_scan.segment_minima(db, vec, vec, torch.zeros((4, 128)))
    db = torch.zeros((256, 128), dtype=torch.float64)
    vec = torch.zeros(256)
    with pytest.raises(TypeError):
        fused_scan.segment_minima(db, vec, vec, torch.zeros((4, 128)))
    with pytest.raises(ValueError, match=r"\(N, d\)"):
        fused_scan.segment_minima(db.float(), vec, vec, torch.zeros((4, 64)))


@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_flat_topk_fused_matches_jax(metric):
    n, d, b, k = 8192, 128, 16, 10
    db, sq, _, q, valid = scan_inputs(n, d, b, seed=1)
    norm = np.sqrt(sq)
    d_ref, r_ref = jax_scan.flat_topk_fused(
        jnp.asarray(db), jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(q), k=k, metric=metric, db_norm=jnp.asarray(norm),
        interpret=True, precision="highest")
    d_port, r_port = fused_scan.flat_topk_fused(
        torch.from_numpy(db), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), k=k, metric=metric,
        db_norm=torch.from_numpy(norm))
    assert valid[r_port.numpy()].all()
    assert_same_neighbours(r_port, d_port, r_ref, d_ref, rtol=DIST_RTOL,
                           atol=1e-6)


def test_flat_topk_fused_exact_vs_numpy_float64():
    n, d, b, k = 4096, 64, 8, 5
    rng = np.random.default_rng(1)
    db = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    q = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    dist, rows = fused_scan.flat_topk_fused(
        torch.from_numpy(db), torch.from_numpy(sq),
        torch.ones(n, dtype=torch.bool), torch.from_numpy(q), k=k)
    d2 = ((q.astype(np.float64)[:, None, :]
           - db.astype(np.float64)[None, :, :]) ** 2).sum(-1)
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    np.testing.assert_array_equal(rows.numpy(), ref_rows)
    np.testing.assert_allclose(
        dist.numpy(), np.sqrt(np.take_along_axis(d2, ref_rows, 1)),
        rtol=DIST_RTOL)


def test_flat_topk_fused_pads_past_live_rows():
    n, d = 1024, 32
    rng = np.random.default_rng(2)
    db = rng.normal(size=(n, d)).astype(np.float32)
    valid = np.zeros(n, dtype=bool)
    valid[[37, 900]] = True
    q = np.vstack([db[37] + 1e-3, db[900]]).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    dist, rows = fused_scan.flat_topk_fused(
        torch.from_numpy(db), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), k=4)
    assert rows[0, 0] == 37 and rows[1, 0] == 900
    assert set(rows[:, :2].flatten().tolist()) == {37, 900}
    assert (rows[:, 2:] == -1).all()
    assert torch.isinf(dist[:, 2:]).all()
    assert dist[1, 0] == 0.0


def test_topk_smallest_matches_full_sort():
    rng = np.random.default_rng(3)
    m = rng.permutation(64 * 512).reshape(64, 512).astype(np.float32)
    vals, idx = fused_scan.topk_smallest(torch.from_numpy(m), 24)
    order = np.argsort(m, axis=1)[:, :24]
    np.testing.assert_array_equal(idx.numpy(), order)
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(m, order, 1))


def test_rerank_segments_blocks_queries(monkeypatch):
    # Stage 2 runs in query blocks under STAGE2_BYTES: blocking must not
    # change the answer.
    n, d, b, k = 2048, 128, 24, 6
    db, sq, pen, q, valid = scan_inputs(n, d, b, seed=4)
    t = [torch.from_numpy(a) for a in (db, sq, pen, q, valid)]
    sid = fused_scan.select_segments(
        fused_scan.segment_minima(t[0], t[1], t[2], t[3]), 16)
    whole = fused_scan.rerank_segments(t[0], t[4], t[3], sid, k=k)
    # 5 queries a block.
    monkeypatch.setattr(fused_scan, "STAGE2_BYTES", 5 * 16 * 128 * d * 4)
    blocked = fused_scan.rerank_segments(t[0], t[4], t[3], sid, k=k)
    torch.testing.assert_close(blocked[0], whole[0], rtol=0, atol=0)
    torch.testing.assert_close(blocked[1], whole[1], rtol=0, atol=0)
