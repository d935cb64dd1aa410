"""
The port's PQ list scans (``smqtk_indexing_tpu_torch/ops/ivf_scan.py``:
the plain version of K8 and the tiled PQ query; ``ops/ivf.ivf_query_pq``)
against the JAX package's (``ops/pallas_ivf.py`` with Pallas in interpret
mode, ``ops/ivf.py``) and against float64, on the CPU. Inputs are numpy
arrays made from a seed: d=96 rows padded to 128 dims, M in {8, 12, 16},
at most 2 tiles and 16 lists, B <= 8. The JAX query functions run
un-jitted (``__wrapped__``), so their inner Pallas kernels compile once
for all the cells instead of once a cell.
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smqtk_indexing_tpu.ops import ivf as jivf
from smqtk_indexing_tpu.ops import pallas_ivf as jpi
from smqtk_indexing_tpu_torch.ops import ivf_scan, pq
from smqtk_indexing_tpu_torch.ops.ivf import ivf_query_pq
from smqtk_indexing_tpu_torch.ops.opq import compose_transform
from tests.test_torch_helpers import assert_same_neighbours

torch.set_num_threads(1)

D, D_PAD, C = 96, 128, 16
TILE = ivf_scan.TILE_ROWS
W = ivf_scan.W_TILED


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clustered(n, seed):
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(C, D)).astype(np.float32) * 2.0
    assigns = np.sort(rng.integers(0, C, size=n)).astype(np.int32)
    rows = centres[assigns] + rng.normal(size=(n, D)).astype(np.float32) \
        * 0.4
    return rows.astype(np.float32), assigns


# ---------------------------------------------------------------------------
# K8: the plain version against Pallas interpret mode
# ---------------------------------------------------------------------------

def _k8_operands(m, seed, n_tiles=2, b=5, p=64):
    """Random uint8 code tiles (codes >= 128 included), stats with +inf
    rows, tables, and windows: dead slots, the last window of the last
    tile (the end of the padded database), a window at a tile's end."""
    rng = np.random.default_rng(seed)
    db3c = rng.integers(0, 256, size=(n_tiles, m, TILE)).astype(np.uint8)
    s2t = (rng.random((n_tiles, 1, TILE)) * 30).astype(np.float32)
    s2t[rng.random(s2t.shape) < 0.05] = np.inf
    lut = rng.normal(size=(b, m * 256)).astype(np.float32)
    ti = rng.integers(0, n_tiles, size=(b, p)).astype(np.int32)
    c0 = (rng.integers(0, (TILE - W) // 128 + 1, size=(b, p)) * 128) \
        .astype(np.int32)
    lo = rng.integers(0, 128, size=(b, p)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 513, size=(b, p)), W) \
        .astype(np.int32)
    ti[:, 0], c0[:, 0], hi[:, 0] = n_tiles - 1, TILE - W, W
    ti[:, 2], c0[:, 2], hi[:, 2] = 0, TILE - W, W
    hi[:, 1] = lo[:, 1]                                 # dead
    hi[:, p - 8:] = lo[:, p - 8:]                       # budget padding
    return db3c, s2t, lut, ti, c0, lo, hi


def _k8_float64(db3c, s2t, lut, ti, c0, lo, hi):
    """K8's scores in float64, and the sum of each score's absolute
    terms."""
    b, p = ti.shape
    m = db3c.shape[1]
    cols = c0[..., None].astype(np.int64) + np.arange(W)
    codes = db3c[ti[..., None, None], np.arange(m)[:, None], cols[:, :, None]]
    vals = np.take_along_axis(
        lut.astype(np.float64).reshape(b, 1, m, 256).repeat(p, 1),
        codes.astype(np.int64), axis=3)                 # (b, P, M, W)
    s2 = s2t[ti[..., None], 0, cols].astype(np.float64)
    ok = (np.arange(W) >= lo[..., None]) & (np.arange(W) < hi[..., None])
    exact = np.where(ok, s2 - 2.0 * vals.sum(2), np.inf)
    mag = np.where(ok, np.abs(s2) + 2.0 * np.abs(vals).sum(2), np.inf)
    return exact, mag


@pytest.mark.parametrize("m", [8, 12, 16])
def test_k8_plain_version_matches_pallas_and_float64(m):
    ops = _k8_operands(m, seed=11 + m)
    db3c, s2t, lut, ti, c0, lo, hi = ops
    b, p = ti.shape
    port = ivf_scan.ivf_list_scores_tiled_pq(*(_t(x) for x in ops)).numpy()
    ref = np.asarray(jpi.ivf_list_scores_tiled_pq(
        jnp.asarray(db3c.view(np.int8)), jnp.asarray(s2t), jnp.asarray(lut),
        *(jnp.asarray(x.reshape(-1)) for x in (ti, c0, lo, hi)),
        n_probe=p, interpret=True)).reshape(b, p, W)
    assert port.shape == (b, p, W)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    assert np.isinf(port[:, 1]).all() and np.isinf(port[:, p - 8:]).all()
    fin = np.isfinite(ref)
    # The TPU's split-bf16 table leaves ~2^-16 of the score's magnitude.
    for i in range(b):
        tol = 4.0 * 2.0 ** -16 * (s2t[np.isfinite(s2t)].max() + 2.0 * np.abs(
            lut[i].reshape(m, 256)).max(1).sum())
        assert np.abs(port[i][fin[i]] - ref[i][fin[i]]).max() <= tol
    exact, mag = _k8_float64(*ops)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(exact))
    fin = np.isfinite(exact)
    assert (np.abs(port[fin] - exact[fin]) <= 1e-5 * mag[fin]).all()
    # A +inf stat (a removed row) stays +inf inside its window.
    cols = c0[..., None].astype(np.int64) + np.arange(W)
    in_win = (np.arange(W) >= lo[..., None]) & (np.arange(W) < hi[..., None])
    dead = np.isinf(s2t[ti[..., None], 0, cols])
    assert (in_win & dead).any() and np.isinf(port[in_win & dead]).all()


def test_k8_wrapper_refuses_bad_operands():
    db3c = torch.zeros((1, 8, TILE), dtype=torch.uint8)
    idx = (torch.zeros((2, 3), dtype=torch.int32),) * 4
    with pytest.raises(ValueError, match="lut"):
        ivf_scan.ivf_list_scores_tiled_pq(db3c, torch.zeros((1, 1, TILE)),
                                          torch.zeros((2, 100)), *idx)
    with pytest.raises(ValueError, match="uint8"):
        ivf_scan.ivf_list_scores_tiled_pq(
            db3c.float(), torch.zeros((1, 1, TILE)),
            torch.zeros((2, 8 * 256)), *idx)


# ---------------------------------------------------------------------------
# The tiled PQ query against the JAX package
# ---------------------------------------------------------------------------

M = 16
N_ROWS = 2 * TILE - 300


@functools.lru_cache(maxsize=None)
def _pq_tiled(metric, residual, rotate, seed=20):
    """The code tier's PQ layout, built as ``_ivf_code.upload_tiled``
    builds it: codes of codec-grid rows (residuals to the list centroid
    with ``residual``; under a random rotation with ``rotate``), float64
    stats with +inf on dead rows and padding, the sublist tables."""
    rows, assigns = _clustered(N_ROWS, seed)
    if metric == "cosine":
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    cents = np.stack([rows[assigns == i].mean(0) for i in range(C)])
    cents_pad = np.zeros((C, D_PAD), np.float32)
    cents_pad[:, :D] = cents
    perm = pq.pq_perm(D_PAD, M)
    rot = None
    if rotate:
        rot = np.linalg.qr(np.random.default_rng(seed).normal(
            size=(D_PAD, D_PAD)))[0].astype(np.float32)
    rows_c = pq.pq_prep_queries(rows, perm)
    cents_c = pq.pq_prep_queries(cents_pad, perm, rot)
    if residual:
        rows_c = rows_c - pq.pq_prep_queries(cents_pad, perm)[assigns]
    if rot is not None:
        rows_c = rows_c @ rot
    cb = pq.pq_train(rows_c[:2048], M, n_iter=2)
    n_pad = 2 * TILE
    codes = np.zeros((n_pad, M), np.uint8)
    codes[:N_ROWS] = pq.pq_encode_np(rows_c, cb)
    x64 = pq.pq_decode_np(codes, cb).astype(np.float64)
    asg = np.zeros(n_pad, np.int32)
    asg[:N_ROWS] = assigns
    if residual:
        x64 = x64 + cents_c[asg]
    s2 = (x64 * x64).sum(1) if metric != "inner_product" \
        else np.zeros(n_pad)
    dead = np.ones(n_pad, bool)
    dead[:N_ROWS] = np.random.default_rng(seed + 1).random(N_ROWS) < 0.03
    s2[dead] = np.inf
    db3c = codes.reshape(2, TILE, M).transpose(0, 2, 1).copy()
    lens = np.bincount(assigns, minlength=C)
    v_tile, v_col, v_len, v_orig, _ = ivf_scan.build_tiled_csr(
        lens[None, :], np.zeros(1, np.int64))
    table = ivf_scan.build_slot_table(v_orig, C)
    transform = compose_transform(perm, rot) if rotate else perm
    q = np.zeros((8, D_PAD), np.float32)
    pick = np.random.default_rng(seed + 2).integers(0, N_ROWS, 8)
    q[:, :D] = rows[pick] + np.random.default_rng(seed + 3).normal(
        size=(8, D)).astype(np.float32) * 0.1
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
    return dict(db3c=db3c, s2t=s2.astype(np.float32).reshape(2, 1, TILE),
                cb=cb, transform=transform, cents=cents_pad, table=table,
                csr=(v_tile, v_col, v_len), q=q, x64=x64, dead=dead,
                res_cents=cents_c.astype(np.float32) if residual else None,
                row2list=asg if residual else None)


TABLE_CELLS = [(metric, rerank, rotate, residual)
               for metric in ("euclidean", "inner_product", "cosine")
               for rerank in ("score", "gather")
               for rotate in (False, True)
               for residual in (False, True)
               if not (residual and metric == "inner_product")]


@pytest.mark.parametrize("metric,rerank,rotate,residual", TABLE_CELLS)
def test_tiled_table_pq_query_matches_jax(metric, rerank, rotate, residual):
    lay = _pq_tiled(metric, residual, rotate)
    v_tile, v_col, v_len = lay["csr"]
    k, nprobe = 8, 4
    res = {} if not residual else dict(res_cents=lay["res_cents"],
                                       row2list=lay["row2list"])
    args = (lay["db3c"], lay["s2t"], lay["cb"], lay["transform"],
            lay["cents"], lay["table"], v_tile, v_col, v_len, lay["q"])
    d_p, r_p = ivf_scan.ivf_query_dma_tiled_table_pq(
        *(_t(x) for x in args[:5]), _t(lay["table"]).long(),
        *(_t(x) for x in args[6:]), k=k, nprobe_orig=nprobe, rerank=rerank,
        metric=metric, **{key: _t(v) for key, v in res.items()})
    d_j, r_j = jpi.ivf_query_dma_tiled_table_pq.__wrapped__(
        jnp.asarray(lay["db3c"].view(np.int8)),
        *(jnp.asarray(x) for x in args[1:]), k=k, nprobe_orig=nprobe,
        interpret=True, rerank=rerank, metric=metric,
        **{key: jnp.asarray(v) for key, v in res.items()})
    d_p, r_p = d_p.numpy(), r_p.numpy()
    d_j, r_j = np.asarray(d_j), np.asarray(r_j)
    assert (r_p >= 0).all()
    if rerank == "gather":
        assert_same_neighbours(r_p, d_p, r_j, d_j, rtol=1e-5, atol=1e-5)
        return
    # Score mode: the JAX scores carry the split-bf16 table's residual,
    # ~2^-16 of ||q||^2 + s2 on the squared distance (4x margin); compare
    # squared distances (inner_product: the score itself).
    q_sq = (lay["q"].astype(np.float64) ** 2).sum(1)
    s2max = lay["s2t"][np.isfinite(lay["s2t"])].max()
    for i in range(lay["q"].shape[0]):
        tol = 4.0 * 2.0 ** -16 * (q_sq[i] + s2max + 4.0 * np.sqrt(
            q_sq[i] * max(s2max, 1.0)))
        if metric == "cosine":
            a, b = (1.0 - np.cos(d_p[i:i + 1] * np.pi / 2)) * 2, \
                (1.0 - np.cos(d_j[i:i + 1] * np.pi / 2)) * 2
        elif metric == "euclidean":
            a, b = d_p[i:i + 1] ** 2, d_j[i:i + 1] ** 2
        else:
            a, b = d_p[i:i + 1], d_j[i:i + 1]
        assert_same_neighbours(r_p[i:i + 1], a, r_j[i:i + 1], b, rtol=0.0,
                               atol=tol)


@pytest.mark.parametrize("residual", [False, True])
def test_tiled_pq_full_probe_is_exact_wrt_reconstruction(residual):
    # Every list probed: the float64 top-k over the live reconstructions
    # (tests/ops/test_pallas_ivf_pq_tiled.py:67-85).
    lay = _pq_tiled("euclidean", residual, rotate=residual)
    v_tile, v_col, v_len = lay["csr"]
    k = 8
    kw = {} if not residual else dict(res_cents=_t(lay["res_cents"]),
                                      row2list=_t(lay["row2list"]))
    d_p, r_p = ivf_scan.ivf_query_dma_tiled_table_pq(
        _t(lay["db3c"]), _t(lay["s2t"]), _t(lay["cb"]),
        _t(lay["transform"]), _t(lay["cents"]), _t(lay["table"]).long(),
        _t(v_tile), _t(v_col), _t(v_len), _t(lay["q"]), k=k, nprobe_orig=C,
        **kw)
    q_c = pq.pq_transform_queries(_t(lay["q"]), _t(lay["transform"])) \
        .double().numpy()
    dist = np.sqrt(((q_c[:, None] - lay["x64"][None]) ** 2).sum(-1))
    dist[:, lay["dead"]] = np.inf
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), ids,
                           np.take_along_axis(dist, ids, 1), rtol=1e-5,
                           atol=1e-5)


def test_tiled_pq_query_blocks_and_removed_rows(monkeypatch):
    # A score budget of a few queries a block gives the results of one
    # block; a poisoned row never returns.
    lay = _pq_tiled("euclidean", False, False, seed=30)
    v_tile, v_col, v_len = lay["csr"]
    args = [_t(lay[k]) for k in ("db3c", "s2t", "cb", "transform", "cents")]
    rest = [_t(lay["table"]).long(), _t(v_tile), _t(v_col), _t(v_len),
            _t(lay["q"])]
    one = ivf_scan.ivf_query_dma_tiled_table_pq(*args, *rest, k=8,
                                                nprobe_orig=C)
    victim = int(one[1][0, 0])
    monkeypatch.setattr(ivf_scan, "SCORE_BYTES",
                        3 * (4 * 64 * W + 16 * M * 128))
    blocked = ivf_scan.ivf_query_dma_tiled_table_pq(*args, *rest, k=8,
                                                    nprobe_orig=C)
    monkeypatch.undo()
    np.testing.assert_array_equal(blocked[1].numpy(), one[1].numpy())
    args[1] = args[1].clone()
    args[1][victim // TILE, 0, victim % TILE] = float("inf")
    _, rows = ivf_scan.ivf_query_dma_tiled_table_pq(*args, *rest, k=8,
                                                    nprobe_orig=C)
    assert victim not in rows.numpy()


# ---------------------------------------------------------------------------
# The row-major PQ list gather against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric,residual", [
    ("euclidean", False), ("inner_product", False), ("cosine", False),
    ("euclidean", True)])
def test_list_gather_pq_query_matches_jax(metric, residual):
    from smqtk_indexing_tpu_torch.models.nn_index._ivf_rows import (
        balance_lists,
    )
    n, cap, m = 3000, 4096, 12
    rows, assigns = _clustered(n, seed=40)
    valid = np.zeros(cap, bool)
    valid[:n] = np.random.default_rng(41).random(n) >= 0.03
    cents = np.zeros((C, D_PAD), np.float32)
    cents[:, :D] = np.stack([rows[assigns == i].mean(0) for i in range(C)])
    perm = pq.pq_perm(pq.pq_codec_dim(D_PAD, m), m)
    rows_c = pq.pq_prep_queries(rows, perm)
    cents_c = pq.pq_prep_queries(cents, perm)
    if residual:
        rows_c = rows_c - cents_c[assigns]
    cb = pq.pq_train(rows_c, m, n_iter=4)
    codes = np.zeros((cap, m), np.uint8)
    codes[:n] = pq.pq_encode_np(rows_c, cb)
    x = pq.pq_decode_np(codes, cb)
    r2l = np.zeros(cap, np.int32)
    r2l[:n] = assigns
    if residual:
        x = x + cents_c[r2l]
    s2 = np.where(valid, (x.astype(np.float64) ** 2).sum(1), 0.0) \
        .astype(np.float32)
    v_off, v_len, v_orig, first_virt = balance_lists(
        np.bincount(assigns, minlength=C), n)
    q = np.zeros((8, D_PAD), np.float32)
    q[:, :D] = rows[::400][:8] + 0.1
    q_c = pq.pq_prep_queries(q, perm)
    kw = dict(k=8, nprobe=8, l_max=int(2 ** np.ceil(np.log2(v_len.max()))),
              metric=metric, nprobe_orig=4)
    res = (cents_c, r2l) if residual else None
    args = (codes, cb, s2, valid, cents_c[v_orig], v_off, v_len, q_c)
    d_p, r_p = ivf_query_pq(
        *(_t(a) for a in args[:5]), _t(v_off).long(), _t(v_len).long(),
        _t(q_c), first_virt=_t(first_virt).long(),
        res_cents=None if res is None else _t(res[0]),
        row2list=None if res is None else _t(res[1]), **kw)
    d_j, r_j = jivf.ivf_query_pq.__wrapped__(
        *(jnp.asarray(a) for a in args), first_virt=jnp.asarray(first_virt),
        res_cents=None if res is None else jnp.asarray(res[0]),
        row2list=None if res is None else jnp.asarray(res[1]), **kw)
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), np.asarray(r_j),
                           np.asarray(d_j), rtol=1e-5, atol=1e-5)
