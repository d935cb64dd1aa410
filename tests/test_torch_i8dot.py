"""
The port's ``i8dot`` int8 x int8 stage 1 on the CPU, against the JAX
package run as its own tests run it (Pallas ``interpret=True``): the query
quantisation ``sq8._i8dot_q``, the int8-query plain versions of K1, K2, K4
and K5, ``sq8_topk(fused=True, i8dot=True)`` and
``sq8_topk_blocked(i8dot=True)``, and the flat SQ8 store under
``SMQTK_TPU_SQ8_I8DOT=1``. Inputs are made with numpy from a seed and fed
to both packages.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops import pallas_scan as jax_scan
from smqtk_indexing_tpu.ops import sq8 as jax_sq8
from smqtk_indexing_tpu.ops.store import VectorStore as JaxVectorStore
from smqtk_indexing_tpu_torch.ops import fused_scan, sq8, store
from smqtk_indexing_tpu_torch.ops.store import VectorStore
from tests.test_torch_helpers import assert_same_neighbours

torch.set_num_threads(1)

D, B = 128, 8
#: Final distances: exact f32 formulas over the same quantized rows.
DIST_ATOL, DIST_RTOL = 1e-5, 1e-6


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_i8dot_q_is_bit_equal_to_jax():
    rng = np.random.default_rng(0)
    t = (rng.normal(size=(B, D)) * 3).astype(np.float32)
    sq = (rng.random(4096) * 50).astype(np.float32)
    sq[7] = np.inf
    for case in range(2):
        if case:
            # max |t| = 127, so g = 1 and these fall exactly on .5: both
            # round half to even.
            t[0, 0] = 127.0
            t[1, :8] = [2.5, -2.5, 3.5, -3.5, 0.5, -0.5, 126.5, -126.5]
        q_j, sq_j = jax_sq8._i8dot_q(jnp.asarray(t), jnp.asarray(sq))
        q_p, sq_p = sq8._i8dot_q(_t(t), _t(sq))
        assert q_p.dtype == torch.int8
        np.testing.assert_array_equal(q_p.numpy(), np.asarray(q_j))
        np.testing.assert_array_equal(sq_p.numpy(), np.asarray(sq_j))
    assert q_p[1, :8].tolist() == [2, -2, 4, -4, 0, 0, 126, -126]
    # An all-zero fold takes the 1e-30 floor, not a division by zero.
    q0, sq0 = sq8._i8dot_q(torch.zeros((2, D)), _t(sq))
    assert not q0.any() and torch.isfinite(sq0[:7]).all()


def _stage1_inputs(n, seed):
    """int8 codes (N, d), their s2 with 2% dead rows and one wholly dead
    segment, and an int8 query with its row stats divided by g."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, size=(n, D)).astype(np.int8)
    a = (rng.random(D) * 0.02).astype(np.float32)
    s2 = ((codes.astype(np.float64) * a) ** 2).sum(1).astype(np.float32)
    pen = np.where(rng.random(n) < 0.02, np.inf, 0.0).astype(np.float32)
    pen[128:256] = np.inf
    t = (rng.normal(size=(B, D)) * a).astype(np.float32)
    q_i8, sq = sq8._i8dot_q(_t(t), _t(s2))
    return codes, sq.numpy(), pen, q_i8.numpy()


def _assert_bit_equal(out, ref):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    np.testing.assert_array_equal(out, ref)


def test_k1_i8i8_plain_version_matches_pallas():
    codes, sq, pen, q = _stage1_inputs(8192, seed=1)
    ref = jax_scan.segment_minima(
        jnp.asarray(codes).T, jnp.asarray(sq)[None], jnp.asarray(pen)[None],
        jnp.asarray(q), interpret=True)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(_t(codes), _t(sq), _t(pen), _t(q))
    # The plain version on CPU tensors is not a kernel launch.
    assert fused_scan.LAUNCHES == before
    assert np.isinf(out.numpy()[:, 1]).all()
    _assert_bit_equal(out, ref)


@pytest.mark.parametrize("kernel", ["tiled", "blocked", "tiled2"])
def test_tiled_i8i8_plain_versions_match_pallas(kernel):
    n = 8192 if kernel == "tiled" else 16384
    codes, sq, pen, q = _stage1_inputs(n, seed=2)
    nseg = n // 128
    if kernel == "blocked":
        blk = fused_scan.blocked_layout(_t(codes))
        ref = jax_scan.segment_minima_blocked(
            jnp.asarray(blk.numpy()), jnp.asarray(sq).reshape(nseg, 128),
            jnp.asarray(pen).reshape(nseg, 128), jnp.asarray(q),
            interpret=True)
        out = fused_scan.segment_minima_blocked(
            blk, _t(sq).view(nseg, 128), _t(pen).view(nseg, 128), _t(q))
        _assert_bit_equal(out, ref)
        return
    db3 = fused_scan.tiled_layout(_t(codes))
    jargs = (jnp.asarray(db3.numpy()), jnp.asarray(sq)[None],
             jnp.asarray(pen)[None], jnp.asarray(q))
    if kernel == "tiled":
        ref = jax_scan.segment_minima_tiled(*jargs, interpret=True)
        out = fused_scan.segment_minima_tiled(db3, _t(sq), _t(pen), _t(q))
        assert np.isinf(out.numpy()[:, 1]).all()
        _assert_bit_equal(out, ref)
        return
    m1_ref, m2_ref = jax_scan.segment_minima_tiled2(*jargs, interpret=True)
    m1, m2 = fused_scan.segment_minima_tiled2(db3, _t(sq), _t(pen), _t(q))
    assert m1.shape == (1, B, 128) and m2.shape == (1, B, 1)
    _assert_bit_equal(m1, m1_ref)
    _assert_bit_equal(m2, m2_ref)


def test_int8_query_needs_int8_codes():
    codes, sq, pen, q = _stage1_inputs(4096, seed=3)
    with pytest.raises(ValueError, match="int8 queries"):
        jax_scan.segment_minima(jnp.asarray(codes, jnp.float32).T,
                                jnp.asarray(sq)[None],
                                jnp.asarray(pen)[None], jnp.asarray(q),
                                interpret=True)
    db = _t(codes).float()
    with pytest.raises(ValueError, match="int8 queries"):
        fused_scan.segment_minima(db, _t(sq), _t(pen), _t(q))
    with pytest.raises(ValueError, match="int8 queries"):
        fused_scan.segment_minima_tiled(fused_scan.tiled_layout(db),
                                        _t(sq), _t(pen), _t(q))
    with pytest.raises(TypeError, match="float32"):
        fused_scan.segment_minima(_t(codes), _t(sq), _t(pen),
                                  _t(q).to(torch.int16))


def _sq8_case():
    """The JAX i8dot test's data (``tests/ops/test_sq8.py:241-252``)."""
    rng = np.random.default_rng(7)
    n, k = 16384, 8
    mat = rng.standard_normal((n, D)).astype(np.float32)
    a, b = sq8.sq8_train(mat)
    codes = sq8.sq8_encode_np(mat, a, b)
    q = rng.standard_normal((B, D)).astype(np.float32)
    valid = np.ones(n, bool)
    valid[50:150] = False            # dead-row +inf poison must survive
    s2, nrm = sq8.sq8_row_stats(_t(codes), _t(a), _t(b))
    return codes, a, b, q, valid, s2, nrm, k


def _check_against(r_port, d_port, r_ref, d_ref, valid):
    assert r_port.dtype == torch.int64 and r_port.shape == (B, 8)
    assert valid[r_port.numpy()].all()
    assert not set(r_port.numpy().ravel().tolist()) & set(range(50, 150))
    assert_same_neighbours(r_port.numpy(), d_port.numpy(), np.asarray(r_ref),
                           np.asarray(d_ref), rtol=DIST_RTOL, atol=DIST_ATOL)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_sq8_topk_i8dot_matches_jax(metric):
    codes, a, b, q, valid, s2, nrm, k = _sq8_case()
    d_ref, r_ref = jax_sq8.sq8_topk(
        jnp.asarray(codes), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(s2.numpy()), jnp.asarray(nrm.numpy()),
        jnp.asarray(valid), jnp.asarray(q), k=k, metric=metric, chunk=4096,
        codes_t=jnp.asarray(codes.T.copy()), interpret=True, i8dot=True)
    args = (_t(codes), _t(a), _t(b), s2, nrm, _t(valid), _t(q))
    d_port, r_port = sq8.sq8_topk(*args, k=k, metric=metric, chunk=4096,
                                  fused=True, i8dot=True)
    _check_against(r_port, d_port, r_ref, d_ref, valid)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_sq8_topk_i8dot_without_fused_changes_nothing(metric):
    # The JAX function's streamed stage 1 (no codes_t) ignores i8dot; so
    # does the port's unfused one: the same answer as with the flag off.
    codes, a, b, q, valid, s2, nrm, k = _sq8_case()
    d_ref, r_ref = jax_sq8.sq8_topk(
        jnp.asarray(codes), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(s2.numpy()), jnp.asarray(nrm.numpy()),
        jnp.asarray(valid), jnp.asarray(q), k=k, metric=metric, chunk=4096,
        interpret=True, i8dot=True)
    args = (_t(codes), _t(a), _t(b), s2, nrm, _t(valid), _t(q))
    d_port, r_port = sq8.sq8_topk(*args, k=k, metric=metric, chunk=4096,
                                  i8dot=True)
    _check_against(r_port, d_port, r_ref, d_ref, valid)
    d_off, r_off = sq8.sq8_topk(*args, k=k, metric=metric, chunk=4096)
    assert torch.equal(r_port, r_off) and torch.equal(d_port, d_off)


@pytest.mark.parametrize("layout", ["tiled", "blocked"])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_sq8_topk_blocked_i8dot_matches_jax(metric, layout):
    codes, a, b, q, valid, s2, _, k = _sq8_case()
    blk = fused_scan.tiled_layout(_t(codes)) if layout == "tiled" \
        else fused_scan.blocked_layout(_t(codes))
    d_ref, r_ref = jax_sq8.sq8_topk_blocked(
        jnp.asarray(blk.numpy()), jnp.asarray(a), jnp.asarray(b),
        jnp.asarray(s2.numpy()), jnp.asarray(valid), jnp.asarray(q), k=k,
        metric=metric, interpret=True, i8dot=True)
    d_port, r_port = sq8.sq8_topk_blocked(
        blk, _t(a), _t(b), s2, _t(valid), _t(q), k=k, metric=metric,
        i8dot=True)
    _check_against(r_port, d_port, r_ref, d_ref, valid)


def test_store_reads_the_i8dot_flag_per_query(monkeypatch):
    # 70,000 rows: capacity 131,072, past one streamed block and a multiple
    # of 4096, so the port's stage 1 is K1's (its plain version here). The
    # JAX store on the CPU streams under the same flag; both are exact
    # over the same quantized rows.
    rng = np.random.default_rng(4)
    x = rng.random((70000, 24), dtype=np.float32)
    q = rng.random((6, 24), dtype=np.float32)
    seen = []
    real = store.sq8_topk

    def spy(*args, **kwargs):
        seen.append(kwargs["i8dot"])
        return real(*args, **kwargs)

    monkeypatch.setattr(store, "sq8_topk", spy)
    port = VectorStore("sq8", device="cpu")
    jax_store = JaxVectorStore("sq8")
    for s in (port, jax_store):
        s.build(x, list(range(70000)))
        s.remove(list(range(0, 70000, 11)))
    assert port._sq8_fused_eligible("euclidean")
    monkeypatch.setenv("SMQTK_TPU_SQ8_I8DOT", "1")
    for metric in ("euclidean", "inner_product"):
        d_p, u_p, _ = port.knn(q, 8, metric)
        d_j, u_j, _ = jax_store.knn(q, 8, metric)
        assert_same_neighbours(np.array(u_p), d_p, np.array(u_j), d_j,
                               1e-5, 1e-5)
        assert not {u for u in np.array(u_p).ravel() if u % 11 == 0}
    # cosine is not fused, so the flag does not reach it.
    port.knn(q, 8, "cosine")
    monkeypatch.setenv("SMQTK_TPU_SQ8_I8DOT", "0")
    port.knn(q, 8, "euclidean")
    assert seen == [True, True, False, False]
