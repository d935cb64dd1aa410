"""
The port's single-copy SQ8 capacity scan on the CPU, against the JAX
package run as its own tests run it (Pallas ``interpret=True``): the layout
builders, stage 1 over the tiled and blocked layouts (K2, K4, K5; their
plain versions here), the step-major selection, ``sq8_topk_blocked`` for
both layouts and both metrics, and the capacity module at a mini size.
Inputs are made with numpy from a seed and fed to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops import pallas_scan as jax_scan
from smqtk_indexing_tpu.ops import sq8 as jax_sq8
from smqtk_indexing_tpu_torch.examples import capacity_100m
from smqtk_indexing_tpu_torch.ops import fused_scan, sq8
from tests.test_torch_helpers import assert_same_neighbours, scan_inputs

torch.set_num_threads(1)

D, B = 128, 8
#: Stage-1 minima, port vs JAX: both sum exact products (f32 x f32 at
#: "highest", bf16 x bf16 or bf16 x int8) in f32 in different orders, so
#: they differ by f32 rounding of the sum only: within 1e-5 of the largest
#: score magnitude (the sums' terms are of that size here).
STAGE1_REL = 1e-5
#: Final distances: exact f32 formulas over the same quantized rows.
DIST_ATOL, DIST_RTOL = 1e-5, 1e-6


def _db(db, dtype):
    """The numpy rows as the stage-1 database: f32, bf16, or int8 codes."""
    if dtype == "int8":
        return np.clip(np.rint(db * 10), -127, 127).astype(np.int8)
    return db


def _inputs(n, dtype, seed=0):
    """(rows (N, d) numpy in the database dtype, db_sq, penalty, q), with
    2% dead rows and one wholly dead segment."""
    db, _, pen, q, _ = scan_inputs(n, D, B, seed=seed)
    rows = _db(db, dtype)
    if dtype == "bfloat16":
        x = torch.from_numpy(db).to(torch.bfloat16).float().numpy()
    else:
        x = rows.astype(np.float32)
    sq = np.einsum("ij,ij->i", x, x).astype(np.float32)
    return rows, sq, pen, q


def _torch(rows, dtype):
    return torch.from_numpy(rows).to(getattr(torch, dtype))


def _jax(a, dtype):
    return jnp.asarray(a, dtype=getattr(jnp, dtype))


def _assert_minima(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0,
                               atol=STAGE1_REL * np.abs(ref[fin]).max())


@pytest.mark.parametrize("tile_n", [4096, 256, 128])
def test_layout_builders_match_jax_byte_for_byte(tile_n):
    rng = np.random.default_rng(0)
    codes = rng.integers(-127, 128, size=(8192, 96)).astype(np.int8)
    ref = codes.reshape(8192 // tile_n, tile_n, 96).transpose(0, 2, 1)
    got = fused_scan.tiled_layout(torch.from_numpy(codes), tile_n)
    assert got.is_contiguous()
    assert got.numpy().tobytes() == np.ascontiguousarray(ref).tobytes()
    if tile_n == 128:
        blk = fused_scan.blocked_layout(torch.from_numpy(codes))
        assert torch.equal(blk, got)
    with pytest.raises(ValueError, match="multiples"):
        fused_scan.tiled_layout(torch.from_numpy(codes[:4000]), tile_n)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_segment_minima_tiled_matches_jax(dtype):
    n = 8192
    rows, sq, pen, q = _inputs(n, dtype)
    db3 = np.ascontiguousarray(
        rows.reshape(n // 4096, 4096, D).transpose(0, 2, 1))
    ref = jax_scan.segment_minima_tiled(
        _jax(db3, dtype), jnp.asarray(sq)[None], jnp.asarray(pen)[None],
        jnp.asarray(q), interpret=True, precision="highest")
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_tiled(
        fused_scan.tiled_layout(_torch(rows, dtype)), torch.from_numpy(sq),
        torch.from_numpy(pen), torch.from_numpy(q))
    # The plain version on CPU tensors is not a kernel launch.
    assert fused_scan.LAUNCHES == before
    _assert_minima(out, ref)
    assert np.isinf(out.numpy()[:, 1]).all()
    # The same minima as K1 over the row-major rows, under the tiled
    # kernels' f32 mode ("highest": they add in FFMA).
    flat = fused_scan.segment_minima(_torch(rows, dtype), torch.from_numpy(sq),
                                     torch.from_numpy(pen),
                                     torch.from_numpy(q), precision="highest")
    torch.testing.assert_close(out, flat, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_segment_minima_blocked_matches_jax(dtype):
    n = 16384                  # the JAX kernel takes 128 segments a step
    rows, sq, pen, q = _inputs(n, dtype, seed=1)
    nseg = n // 128
    blk = np.ascontiguousarray(rows.reshape(nseg, 128, D).transpose(0, 2, 1))
    ref = jax_scan.segment_minima_blocked(
        _jax(blk, dtype), jnp.asarray(sq).reshape(nseg, 128),
        jnp.asarray(pen).reshape(nseg, 128), jnp.asarray(q), interpret=True)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_blocked(
        fused_scan.blocked_layout(_torch(rows, dtype)),
        torch.from_numpy(sq).view(nseg, 128),
        torch.from_numpy(pen).view(nseg, 128), torch.from_numpy(q))
    assert fused_scan.LAUNCHES == before
    _assert_minima(out, ref)
    with pytest.raises(ValueError, match="nseg"):
        fused_scan.segment_minima_blocked(
            fused_scan.blocked_layout(_torch(rows, dtype)),
            torch.from_numpy(sq), torch.from_numpy(pen), torch.from_numpy(q))


def _stepmajor_case(n):
    """int8 codes in the tiled layout at ``n`` rows: (port db3, JAX m1 and
    m2, port (db_sq, penalty, q))."""
    rows, sq, pen, q = _inputs(n, "int8", seed=n)
    db3 = fused_scan.tiled_layout(torch.from_numpy(rows))
    m1, m2 = jax_scan.segment_minima_tiled2(
        jnp.asarray(db3.numpy()), jnp.asarray(sq)[None],
        jnp.asarray(pen)[None], jnp.asarray(q), interpret=True)
    return db3, np.array(m1), np.array(m2), \
        tuple(torch.from_numpy(a) for a in (sq, pen, q))


#: (rows, G, bw): 1, 2 and 4 tiles a step.
STEP_CASES = [(4096, 32, 16), (8192, 64, 16), (16384, 128, 128)]


@pytest.mark.parametrize("n,g,bw", STEP_CASES)
def test_segment_minima_tiled2_matches_jax(n, g, bw):
    db3, m1_ref, m2_ref, (sq, pen, q) = _stepmajor_case(n)
    assert fused_scan.step_shape(n // 4096, 4096) == (1, g, bw)
    before = dict(fused_scan.LAUNCHES)
    m1, m2 = fused_scan.segment_minima_tiled2(db3, sq, pen, q)
    assert fused_scan.LAUNCHES == before
    assert m1.shape == (1, B, g) and m2.shape == (1, B, g // bw)
    _assert_minima(m1, m1_ref)
    _assert_minima(m2, m2_ref)
    # m2 is the group minimum of m1, bit for bit.
    torch.testing.assert_close(m2, m1.view(1, B, g // bw, bw).amin(-1),
                               rtol=0, atol=0)


def test_step_shape_halves_tiles_per_step():
    # 24,576 tiles (the capacity layout): 8 tiles a step, G = 256, bw 128.
    assert fused_scan.step_shape(24576, 4096) == (3072, 256, 128)
    assert fused_scan.step_shape(6, 4096) == (3, 64, 16)
    assert fused_scan.step_shape(12, 2048) == (3, 64, 16)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_scan.step_shape(3, 128)


@pytest.mark.parametrize("n,g,bw", STEP_CASES)
def test_topk_segments_stepmajor_matches_jax(n, g, bw):
    _, m1, m2, _ = _stepmajor_case(n)
    s_keep = 24
    v_ref, s_ref = jax_scan.topk_segments_stepmajor(
        jnp.asarray(m1), jnp.asarray(m2), s_keep)
    v, s = fused_scan.topk_segments_stepmajor(
        torch.from_numpy(m1), torch.from_numpy(m2), s_keep)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_ref))
    # Global segment ids step * G + g, equal up to ties of equal minima.
    assert_same_neighbours(s.numpy(), v.numpy(), np.asarray(s_ref),
                           np.asarray(v_ref), rtol=0.0)
    minima = m1.transpose(1, 0, 2).reshape(B, -1)
    np.testing.assert_array_equal(np.take_along_axis(minima, s.numpy(), 1),
                                  v.numpy())


def test_topk_segments_stepmajor_across_steps():
    # Three steps: ids past the first step carry step * G.
    rng = np.random.default_rng(5)
    m1 = rng.permutation(3 * 4 * 32).astype(np.float32).reshape(3, 4, 32)
    m2 = m1.reshape(3, 4, 2, 16).min(-1)
    v, s = fused_scan.topk_segments_stepmajor(
        torch.from_numpy(m1), torch.from_numpy(m2), 10)
    flat = m1.transpose(1, 0, 2).reshape(4, 96)
    order = np.argsort(flat, axis=1)[:, :10]
    np.testing.assert_array_equal(s.numpy(), order)
    np.testing.assert_array_equal(v.numpy(),
                                  np.take_along_axis(flat, order, 1))


def _sq8_case():
    """The JAX test's data (``tests/ops/test_sq8.py:195-206``)."""
    rng = np.random.default_rng(3)
    n, k = 16384, 8
    mat = rng.random((n, D), dtype=np.float32) * 10
    a, b = sq8.sq8_train(mat)
    codes = sq8.sq8_encode_np(mat, a, b)
    q = rng.random((B, D), dtype=np.float32) * 10
    valid = np.ones(n, bool)
    valid[200:300] = False
    s2, nrm = sq8.sq8_row_stats(torch.from_numpy(codes), torch.from_numpy(a),
                                torch.from_numpy(b))
    return codes, a, b, q, valid, s2, nrm, k


@pytest.mark.parametrize("layout", ["tiled", "blocked"])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_sq8_topk_blocked_matches_jax_and_sq8_topk(metric, layout):
    codes, a, b, q, valid, s2, nrm, k = _sq8_case()
    ct = torch.from_numpy(codes)
    blk = fused_scan.tiled_layout(ct) if layout == "tiled" \
        else fused_scan.blocked_layout(ct)
    d_ref, r_ref = jax_sq8.sq8_topk_blocked(
        jnp.asarray(blk.numpy()), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(s2.numpy()), jnp.asarray(valid), jnp.asarray(q), k=k,
        metric=metric, interpret=True)
    launches = dict(fused_scan.LAUNCHES)
    args = (torch.from_numpy(a), torch.from_numpy(b), s2,
            torch.from_numpy(valid), torch.from_numpy(q))
    d_port, r_port = sq8.sq8_topk_blocked(blk, *args, k=k, metric=metric)
    assert launches == fused_scan.LAUNCHES
    assert r_port.dtype == torch.int64 and r_port.shape == (B, k)
    assert valid[r_port.numpy()].all()
    assert_same_neighbours(r_port.numpy(), d_port.numpy(), np.asarray(r_ref),
                           np.asarray(d_ref), rtol=DIST_RTOL, atol=DIST_ATOL)
    d_flat, r_flat = sq8.sq8_topk(ct, args[0], args[1], s2, nrm, args[3],
                                  args[4], k=k, metric=metric, chunk=4096)
    assert_same_neighbours(r_port.numpy(), d_port.numpy(), r_flat.numpy(),
                           d_flat.numpy(), rtol=DIST_RTOL, atol=DIST_ATOL)


def test_sq8_topk_blocked_refuses_other_metrics():
    codes, a, b, q, valid, s2, _, _ = _sq8_case()
    with pytest.raises(ValueError, match="euclidean"):
        sq8.sq8_topk_blocked(
            fused_scan.blocked_layout(torch.from_numpy(codes)),
            torch.from_numpy(a), torch.from_numpy(b), s2,
            torch.from_numpy(valid), torch.from_numpy(q), k=2,
            metric="cosine")


def test_tiled_stage1_rejects_bad_inputs():
    db3 = torch.zeros((2, D, 200), dtype=torch.int8)
    vec = torch.zeros(400)
    q = torch.zeros((4, D))
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_scan.segment_minima_tiled(db3, vec, vec, q)
    db3 = torch.zeros((2, D, 256), dtype=torch.float64)
    vec = torch.zeros(512)
    with pytest.raises(TypeError):
        fused_scan.segment_minima_tiled2(db3, vec, vec, q)
    with pytest.raises(ValueError, match="N=512"):
        fused_scan.segment_minima_tiled(db3.float(), vec[:100], vec, q)


def test_capacity_module_at_a_mini_size():
    # 8 tiles (32,768 rows): the planted rows are the true top-10 for
    # both batch sizes, with the example's margin.
    cap = capacity_100m.build(8, "cpu", seed=0)
    assert cap.codes.shape == (8, D, 4096) and cap.codes.dtype == torch.int8
    n = 8 * 4096
    # The planted rows hold their codes, and s2 is the codec's row stat.
    _, planted, truth = capacity_100m.plant(n)
    r = truth.reshape(-1)
    got = cap.codes[r // 4096, :, r % 4096].numpy()
    np.testing.assert_array_equal(got, planted)
    rows = cap.codes.transpose(1, 2).reshape(n, D)
    s2, _ = sq8.sq8_row_stats(rows, cap.a, cap.b)
    torch.testing.assert_close(cap.s2, s2, rtol=1e-6, atol=0)
    for batch in (capacity_100m.B, capacity_100m.B_BIG):
        dists, rows_out = capacity_100m.scan(cap, batch)
        assert dists.shape == (batch, capacity_100m.K)
        res = capacity_100m.check(cap, dists, rows_out)
        assert res["recall_at_10"] == 1.0
        assert res["planted_to_random_margin"] > 1.0
    with pytest.raises(ValueError, match="CUDA"):
        capacity_100m.stages(cap)
    if not torch.cuda.is_available():
        # Asked for the card where there is none, the build raises.
        with pytest.raises(RuntimeError, match="is_available"):
            capacity_100m.build(1, "cuda")
