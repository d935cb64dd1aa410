"""
The port's IVF list scans (``smqtk_indexing_tpu_torch/ops/ivf_scan.py``)
against the JAX package's (``ops/pallas_ivf.py``, Pallas in interpret
mode) on the CPU: the layout helpers, the plain versions of K6, K7 and K3
(``fused_scan.seg_gather_tiled``), and the query functions built on them.
Inputs are numpy arrays made from a seed and fed to both packages: d=96
rows padded to 128 dims, at most 3 tiles and 16 lists, B <= 8.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smqtk_indexing_tpu.ops import pallas_ivf as jpi
from smqtk_indexing_tpu.ops import pallas_scan as jps
from smqtk_indexing_tpu.ops import sq8 as jsq8
from smqtk_indexing_tpu_torch.models.nn_index._ivf_rows import balance_lists
from smqtk_indexing_tpu_torch.ops import fused_scan, ivf_scan
from smqtk_indexing_tpu_torch.ops.device import capacity_for
from smqtk_indexing_tpu_torch.ops.sq8 import sq8_encode_np, sq8_train
from tests.test_torch_helpers import (
    assert_same_neighbours, chunked_tiled_layout, near_rows,
)

torch.set_num_threads(1)

D, D_PAD, C = 96, 128, 16
TILE = ivf_scan.TILE_ROWS
W = ivf_scan.W_TILED
#: Plain versions against Pallas interpret mode on the same f32 operands:
#: exact products summed in different orders.
RTOL = 1e-5


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _clustered(n, seed, c=C):
    """(rows (n, D) f32 sorted by list, assigns (n,) int32, centres)."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(size=(c, D)).astype(np.float32) * 2.0
    assigns = np.sort(rng.integers(0, c, size=n)).astype(np.int32)
    rows = (centres[assigns]
            + rng.normal(size=(n, D)).astype(np.float32) * 0.4)
    return rows.astype(np.float32), assigns, centres


def _queries(rows, b, seed):
    rng = np.random.default_rng(seed)
    pick = rng.integers(0, rows.shape[0], size=b)
    return (rows[pick] + rng.normal(size=(b, D)) * 0.1).astype(np.float32)


def _pad(x):
    out = np.zeros((x.shape[0], D_PAD), np.float32)
    out[:, :D] = x
    return out


def _tiled(n, seed, dead_frac=0.02, metric="euclidean"):
    """The code tier's device layout, built as ``_ivf_code.upload_tiled``
    builds it (codes of ``n`` rows in 3 or fewer tiles, +inf stats on dead
    rows and padding), with the sublist tables of both packages."""
    rows, assigns, centres = _clustered(n, seed)
    if metric == "cosine":
        rows = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    a, b = sq8_train(rows)
    codes = sq8_encode_np(rows, a, b)
    n_tiles = -(-n // TILE)
    n_pad = n_tiles * TILE
    a_p = np.full(D_PAD, 1e-12, np.float32)
    b_p = np.zeros(D_PAD, np.float32)
    a_p[:D], b_p[:D] = a, b
    cp = np.zeros((n_pad, D_PAD), np.int8)
    cp[:n, :D] = codes
    u = cp.astype(np.float32) * a_p
    s2 = np.einsum("nd,nd->n", u, u) if metric != "inner_product" \
        else np.zeros(n_pad, np.float32)
    dead = np.ones(n_pad, bool)
    dead[:n] = np.random.default_rng(seed + 1).random(n) < dead_frac
    s2[dead] = np.inf
    db3 = np.ascontiguousarray(
        cp.reshape(n_tiles, TILE, D_PAD).transpose(0, 2, 1))
    lens = np.bincount(assigns, minlength=C)
    csr = ivf_scan.build_tiled_csr(lens[None, :], np.zeros(1, np.int64))
    table = ivf_scan.build_slot_table(csr[3], C)
    cents = np.stack([rows[assigns == i].mean(0) for i in range(C)])
    return dict(db3=db3, s2t=s2.reshape(n_tiles, 1, TILE), a=a_p, b=b_p,
                cents=_pad(cents), csr=csr, table=table,
                dq=(cp[:n].astype(np.float64) * a_p + b_p), dead=dead[:n],
                rows=rows, assigns=assigns)


# ---------------------------------------------------------------------------
# Layout helpers: identical arrays in both packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2 * TILE + 1000, 3 * TILE])
def test_tiled_csr_and_slot_table_match_jax(n):
    # 3 * TILE rows end the last list at the end of the padded layout;
    # lists cross tile boundaries at both sizes.
    _, assigns, _ = _clustered(n, seed=n)
    lens = np.bincount(assigns, minlength=C)
    lens[5] = 0                                   # an empty list
    bases = np.zeros(1, np.int64)
    port = ivf_scan.build_tiled_csr(lens[None, :], bases)
    ref = jpi.build_tiled_csr(lens[None, :], bases)
    for p, r in zip(port, ref):
        np.testing.assert_array_equal(p, r)
        assert p.dtype == r.dtype
    v_tile, v_col, v_len, v_orig, _ = port
    ends = v_tile.astype(np.int64) * TILE + v_col + v_len
    assert ends.max() == lens.sum()
    assert (v_col + v_len == TILE).any()          # a sublist ends a tile
    np.testing.assert_array_equal(ivf_scan.build_slot_table(v_orig, C),
                                  jpi.build_slot_table(v_orig, C))
    for nprobe in (1, 3, C):
        assert ivf_scan.probe_budget(v_orig, nprobe) \
            == jpi.probe_budget(v_orig, nprobe)


def test_expand_slots_matches_jax():
    lay = _tiled(3 * TILE, seed=3)
    v_tile, v_col, v_len, _, _ = lay["csr"]
    rng = np.random.default_rng(0)
    lists = np.stack([rng.permutation(C)[:4] for _ in range(6)]) \
        .astype(np.int32)
    port = ivf_scan._expand_slots(_t(lay["table"]).long(), _t(lists).long(),
                                  _t(v_tile), _t(v_col), _t(v_len), TILE)
    ref = jpi._expand_slots(jnp.asarray(lay["table"]), jnp.asarray(lists),
                            jnp.asarray(v_tile), jnp.asarray(v_col),
                            jnp.asarray(v_len), TILE)
    for p, r in zip(port, ref[:4]):
        np.testing.assert_array_equal(p.numpy(), np.asarray(r))
    assert port[0].shape[1] == ref[4]             # the padded budget
    c0 = port[1].numpy()
    assert (c0 == TILE - W).any()                 # a clamped window
    assert (c0 % 128 == 0).all() and (c0 + W <= TILE).all()


def test_sq8_codec_matches_jax():
    rows, _, _ = _clustered(2000, seed=4)
    a, b = sq8_train(rows)
    ja, jb = jsq8.sq8_train(rows)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(b, jb)
    np.testing.assert_array_equal(sq8_encode_np(rows * 1.3, a, b),
                                  jsq8.sq8_encode_np(rows * 1.3, a, b))


# ---------------------------------------------------------------------------
# Kernels: plain versions against Pallas interpret mode
# ---------------------------------------------------------------------------

def _k7_operands(lay, b, seed, nprobe=4):
    rng = np.random.default_rng(seed)
    lists = np.stack([rng.permutation(C)[:nprobe] for _ in range(b)]) \
        .astype(np.int32)
    v_tile, v_col, v_len, _, _ = lay["csr"]
    ti, c0, lo, hi = ivf_scan._expand_slots(
        _t(lay["table"]).long(), _t(lists).long(), _t(v_tile), _t(v_col),
        _t(v_len), TILE)
    q = _pad(_queries(lay["rows"], b, seed))
    t = ((q - lay["b"]) * lay["a"]).astype(np.float32)
    return t, q, ti, c0, lo, hi, ti.shape[1]


def test_k7_plain_version_matches_pallas():
    lay = _tiled(3 * TILE, seed=5)
    b = 6
    t, q, ti, c0, lo, hi, n_probe = _k7_operands(lay, b, seed=6)
    port = ivf_scan.ivf_list_scores_tiled(
        _t(lay["db3"]), _t(lay["s2t"]), _t(t), ti, c0, lo, hi).numpy()
    ref = np.asarray(jpi.ivf_list_scores_tiled(
        jnp.asarray(lay["db3"]), jnp.asarray(lay["s2t"]), jnp.asarray(t),
        *(jnp.asarray(x.numpy().reshape(-1)) for x in (ti, c0, lo, hi)),
        n_probe=n_probe, interpret=True)).reshape(b, n_probe, W)
    assert port.shape == (b, n_probe, W)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    assert np.isinf(port).any() and np.isfinite(port).any()
    # The TPU kernel's split-bf16 product leaves ~2^-16 of the score's
    # magnitude (tests/ops/test_pallas_ivf_tiled.py:204-209); 4x margin.
    rq = (q - lay["b"]).astype(np.float64)
    s2max = lay["s2t"][np.isfinite(lay["s2t"])].max()
    fin = np.isfinite(ref)
    for i in range(b):
        tol = 4.0 * 2.0 ** -16 * ((rq[i] ** 2).sum() + s2max)
        assert np.abs(port[i][fin[i]] - ref[i][fin[i]]).max() <= tol


def test_k7_dead_stats_stay_inf():
    lay = _tiled(2 * TILE, seed=7, dead_frac=0.3)
    t, _, ti, c0, lo, hi, _ = _k7_operands(lay, 4, seed=8)
    out = ivf_scan.ivf_list_scores_tiled(
        _t(lay["db3"]), _t(lay["s2t"]), _t(t), ti, c0, lo, hi)
    tile_rows = (ti.long() * TILE + c0.long())[..., None] + torch.arange(W)
    in_win = (torch.arange(W) >= lo[..., None]) & (torch.arange(W)
                                                   < hi[..., None])
    dead = torch.from_numpy(np.isinf(lay["s2t"].reshape(-1)))
    assert torch.isinf(out[in_win & dead[tile_rows]]).all()
    assert torch.isfinite(out[in_win & ~dead[tile_rows]]).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k6_plain_version_matches_pallas(dtype):
    n, b, p = 4096, 5, 12
    rng = np.random.default_rng(9)
    if dtype == "int8":
        db = rng.integers(-127, 128, size=(n, D_PAD)).astype(np.int8)
        a = rng.random(D_PAD).astype(np.float32) * 0.1
    else:
        db = (rng.normal(size=(n, D_PAD)) * 2).astype(np.float32)
        a = np.ones(D_PAD, np.float32)
    t = rng.normal(size=(b, D_PAD)).astype(np.float32)
    starts = (rng.integers(0, (n - ivf_scan.L_MAX) // 32 + 1,
                           size=(b, p)) * 32).astype(np.int32)
    starts[:, 0] = n - ivf_scan.L_MAX            # the last window
    lo = rng.integers(0, 40, size=(b, p)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 480, size=(b, p)),
                    ivf_scan.L_MAX).astype(np.int32)
    hi[:, 1] = lo[:, 1]                           # dead slots
    db_t = _t(db)
    db_j = jnp.asarray(db)
    if dtype == "bfloat16":
        db_t = db_t.to(torch.bfloat16)
        db_j = db_j.astype(jnp.bfloat16)
    port = ivf_scan.ivf_list_scores(db_t, _t(t), _t(a), _t(starts), _t(lo),
                                    _t(hi)).numpy()
    ref = np.asarray(jpi.ivf_list_scores(
        db_j, jnp.asarray(t), jnp.asarray(a.reshape(1, 1, D_PAD)),
        jnp.asarray(starts.reshape(-1)), jnp.asarray(lo.reshape(-1)),
        jnp.asarray(hi.reshape(-1)), n_probe=p, interpret=True))
    # The TPU kernel writes (steps, L_MAX, probes-per-step); map its lanes
    # to the port's (P, L_MAX).
    pps = min(jpi.PROBES_PER_STEP, p)
    ref = ref.reshape(b, p // pps, ivf_scan.L_MAX, pps) \
        .transpose(0, 1, 3, 2).reshape(b, p, ivf_scan.L_MAX)
    np.testing.assert_array_equal(np.isinf(port), np.isinf(ref))
    assert np.isinf(port[:, 1]).all()
    fin = np.isfinite(ref)
    np.testing.assert_allclose(port[fin], ref[fin], rtol=RTOL,
                               atol=RTOL * np.abs(ref[fin]).max())


@pytest.mark.parametrize("dtype", [np.int8, np.float32])
def test_k3_plain_version_is_bit_equal_to_pallas(dtype):
    rng = np.random.default_rng(10)
    db3 = rng.integers(-127, 128, size=(3, D_PAD, TILE)).astype(dtype)
    sid = rng.integers(0, 3 * TILE // 128, size=(5, 18)).astype(np.int32)
    sid[0, :3] = [0, 3 * TILE // 128 - 1, 31]     # first, last, tile end
    port = fused_scan.seg_gather_tiled(_t(db3), _t(sid)).numpy()
    ref = np.asarray(jps._seg_gather_tiled(jnp.asarray(db3),
                                           jnp.asarray(sid), interpret=True))
    assert port.shape == (5, 18, D_PAD, 128) and port.dtype == ref.dtype
    np.testing.assert_array_equal(port, ref)


def test_wrappers_refuse_bad_shapes():
    db3 = torch.zeros((1, 128, TILE), dtype=torch.int8)
    with pytest.raises(ValueError, match="s2t"):
        ivf_scan.ivf_list_scores_tiled(
            db3, torch.zeros((1, 1, 128)), torch.zeros((2, 128)),
            *(torch.zeros((2, 3), dtype=torch.int32),) * 4)
    with pytest.raises(ValueError, match="L_MAX"):
        ivf_scan.ivf_list_scores(
            torch.zeros((100, 128)), torch.zeros((2, 128)),
            torch.ones(128), *(torch.zeros((2, 3), dtype=torch.int32),) * 3)
    with pytest.raises(ValueError, match="tile_n"):
        fused_scan.seg_gather_tiled(torch.zeros((1, 4, 100)),
                                    torch.zeros((1, 1), dtype=torch.int64))


# ---------------------------------------------------------------------------
# Query functions against the JAX package
# ---------------------------------------------------------------------------

#: Distances of the tiled query, port vs JAX: score mode carries the TPU
#: kernel's split-bf16 residual (bounded per query as above); gather mode
#: is exact on the decoded codes in both.
GATHER_RTOL = 1e-5


@pytest.mark.parametrize("rerank", ["score", "gather"])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_tiled_table_query_matches_jax(metric, rerank):
    lay = _tiled(2 * TILE + 700, seed=11, metric=metric)
    v_tile, v_col, v_len, _, _ = lay["csr"]
    cents = lay["cents"]
    q = _pad(_queries(lay["rows"], 8, seed=12))
    if metric == "cosine":
        q = q / np.linalg.norm(q, axis=1, keepdims=True)
        cents = cents / np.linalg.norm(cents, axis=1, keepdims=True)
    k, nprobe = 8, 4
    args = (lay["db3"], lay["s2t"], lay["a"], lay["b"], cents,
            lay["table"], v_tile, v_col, v_len, q)
    d_p, r_p = ivf_scan.ivf_query_dma_tiled_table(
        *(_t(x) for x in args[:5]), _t(lay["table"]).long(),
        *(_t(x) for x in args[6:]), k=k, nprobe_orig=nprobe, rerank=rerank,
        metric=metric)
    d_j, r_j = jpi.ivf_query_dma_tiled_table(
        *(jnp.asarray(x) for x in args), k=k, nprobe_orig=nprobe,
        interpret=True, rerank=rerank, metric=metric)
    d_j, r_j = np.asarray(d_j), np.asarray(r_j)
    assert (r_p.numpy() >= 0).all()
    if rerank == "gather":
        assert_same_neighbours(r_p.numpy(), d_p.numpy(), r_j, d_j,
                               rtol=GATHER_RTOL, atol=1e-5)
        return
    # Score mode: the same rows up to near-tie swaps, distances within the
    # split-bf16 bound, mapped through each metric's finish.
    rq = (q - lay["b"]).astype(np.float64)
    s2max = lay["s2t"][np.isfinite(lay["s2t"])].max()
    for i in range(q.shape[0]):
        tol2 = 4.0 * 2.0 ** -16 * ((rq[i] ** 2).sum() + s2max)
        if metric == "euclidean":
            tol = tol2 / max(2.0 * d_j[i, 0], 1e-6)
        elif metric == "cosine":
            tol = 1e-3
        else:
            tol = tol2
        assert_same_neighbours(r_p.numpy()[i:i + 1], d_p.numpy()[i:i + 1],
                               r_j[i:i + 1], d_j[i:i + 1], rtol=0.0,
                               atol=tol)


def test_tiled_table_query_is_exact_against_float64():
    lay = _tiled(3 * TILE, seed=13, dead_frac=0.05)
    v_tile, v_col, v_len, _, _ = lay["csr"]
    q = _pad(_queries(lay["rows"], 8, seed=14))
    k = 8
    d_p, r_p = ivf_scan.ivf_query_dma_tiled_table(
        *(_t(x) for x in (lay["db3"], lay["s2t"], lay["a"], lay["b"],
                          lay["cents"])), _t(lay["table"]).long(),
        _t(v_tile), _t(v_col), _t(v_len), _t(q), k=k, nprobe_orig=C)
    # Every list probed: the exact top-k of the live decoded codes.
    dist = np.sqrt(((q[:, None, :D].astype(np.float64)
                     - lay["dq"][None, :, :D]) ** 2).sum(-1))
    dist[:, lay["dead"]] = np.inf
    ref = np.argsort(dist, axis=1, kind="stable")[:, :k]
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), ref,
                           np.take_along_axis(dist, ref, 1), rtol=1e-5,
                           atol=1e-5)


def _rows_layout(n, seed, dtype="float32"):
    """The rows tier's device layout (``_ivf_rows.upload_rows``): list
    sorted rows padded to the capacity, the balancer's sublists."""
    rows, assigns, _ = _clustered(n, seed)
    cap = capacity_for(n)
    valid = np.zeros(cap, bool)
    valid[:n] = np.random.default_rng(seed + 1).random(n) >= 0.03
    lens = np.bincount(assigns, minlength=C)
    v_off, v_len, v_orig, first_virt = balance_lists(lens, n)
    cents = np.stack([rows[assigns == i].mean(0) for i in range(C)])
    db = np.zeros((cap, D_PAD), np.float32)
    db[:n, :D] = rows
    out = dict(db=db, valid=valid, cents=_pad(cents)[v_orig], offsets=v_off,
               lens=v_len, first_virt=first_virt, rows=rows,
               max_split=int(np.bincount(v_orig).max()), dq=None)
    if dtype == "sq8":
        a, b = sq8_train(rows[valid[:n]])
        a_p = np.full(D_PAD, 1e-12, np.float32)
        b_p = np.zeros(D_PAD, np.float32)
        a_p[:D], b_p[:D] = a, b
        codes = np.zeros((cap, D_PAD), np.int8)
        codes[:n, :D] = sq8_encode_np(rows, a, b)
        out["db"], out["dq"] = codes, (a_p, b_p)
        x = codes.astype(np.float32) * a_p + b_p
        out["sq"] = np.einsum("nd,nd->n", x, x)
    else:
        out["sq"] = np.einsum("nd,nd->n", db, db)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "sq8"])
def test_row_major_dma_query_matches_jax(dtype):
    # 4096 rows fill their capacity, so the last list's window is clamped
    # to the end of the database.
    lay = _rows_layout(4096, seed=15, dtype=dtype)
    q = _pad(_queries(lay["rows"], 8, seed=16))
    k, nprobe_orig = 8, 3
    n_probe = min(32, len(lay["lens"]))
    db_t, db_j = _t(lay["db"]), jnp.asarray(lay["db"])
    cents_t, cents_j = _t(lay["cents"]), jnp.asarray(lay["cents"])
    if dtype == "bfloat16":
        db_t, db_j = db_t.to(torch.bfloat16), db_j.astype(jnp.bfloat16)
        cents_t = cents_t.to(torch.bfloat16)
        cents_j = cents_j.astype(jnp.bfloat16)
    dq = lay["dq"]
    d_p, r_p = ivf_scan.ivf_query_dma(
        db_t, _t(lay["valid"]), cents_t, _t(lay["offsets"]).long(),
        _t(lay["lens"]).long(), _t(q), k=k, n_probe=n_probe,
        first_virt=_t(lay["first_virt"]).long(), nprobe_orig=nprobe_orig,
        dq=None if dq is None else (_t(dq[0]), _t(dq[1])))
    d_j, r_j = jpi.ivf_query_dma(
        db_j, jnp.asarray(lay["valid"]), cents_j,
        jnp.asarray(lay["offsets"]), jnp.asarray(lay["lens"]),
        jnp.asarray(q), k=k, n_probe=n_probe, interpret=True,
        first_virt=jnp.asarray(lay["first_virt"]), nprobe_orig=nprobe_orig,
        dq=None if dq is None else tuple(jnp.asarray(x) for x in dq))
    assert (r_p.numpy() >= 0).all()
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), np.asarray(r_j),
                           np.asarray(d_j), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_list_gather_query_matches_jax(metric):
    from smqtk_indexing_tpu.ops.ivf import ivf_query as jax_ivf_query
    from smqtk_indexing_tpu_torch.ops.ivf import ivf_query
    lay = _rows_layout(3000, seed=17)
    q = _pad(_queries(lay["rows"], 8, seed=18))
    norm = np.sqrt(lay["sq"])
    l_max = 256
    args = (lay["db"], lay["sq"], norm, lay["valid"], lay["cents"],
            lay["offsets"], lay["lens"], q)
    kw = dict(k=8, nprobe=16, l_max=l_max, metric=metric,
              nprobe_orig=4)
    d_p, r_p = ivf_query(*(_t(x) for x in args[:5]),
                         _t(lay["offsets"]).long(), _t(lay["lens"]).long(),
                         _t(q), first_virt=_t(lay["first_virt"]).long(),
                         **kw)
    d_j, r_j = jax_ivf_query(*(jnp.asarray(x) for x in args),
                             first_virt=jnp.asarray(lay["first_virt"]),
                             **kw)
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), np.asarray(r_j),
                           np.asarray(d_j), rtol=1e-5, atol=1e-5)


def _virtual_query(lay, q, k, n_probe, nprobe_orig, rerank="gather"):
    """``ivf_query_dma_tiled`` of the port and of JAX (interpret mode) on
    the same operands."""
    v_tile, v_col, v_len, v_orig, first_virt = lay["csr"]
    args = (lay["db3"], lay["s2t"], lay["a"], lay["b"],
            lay["cents"][v_orig], v_tile, v_col, v_len, q)
    fv = None if nprobe_orig is None else first_virt
    before = dict(ivf_scan.LAUNCHES)
    d_p, r_p = ivf_scan.ivf_query_dma_tiled(
        *(_t(x) for x in args), k=k, n_probe=n_probe,
        first_virt=None if fv is None else _t(fv), nprobe_orig=nprobe_orig,
        rerank=rerank)
    assert ivf_scan.LAUNCHES == before       # plain versions on the CPU
    d_j, r_j = jpi.ivf_query_dma_tiled(
        *(jnp.asarray(x) for x in args), k=k, n_probe=n_probe,
        first_virt=None if fv is None else jnp.asarray(fv),
        nprobe_orig=nprobe_orig, interpret=True, rerank=rerank)
    return d_p.numpy(), r_p.numpy(), np.asarray(d_j), np.asarray(r_j)


def test_virtual_tiled_query_full_probe_matches_jax_and_float64():
    # tests/ops/test_pallas_ivf_tiled.py:72-95: every virtual slot probed
    # (the budget padded past V): the exact top-k over the decoded codes.
    lay = chunked_tiled_layout()
    q = near_rows(lay["dq"], 8, seed=1)
    n_virt = len(lay["csr"][2])
    budget = -(-n_virt // ivf_scan.P_STEP_TILED) * ivf_scan.P_STEP_TILED
    d_p, r_p, d_j, r_j = _virtual_query(lay, q, 8, budget, None)
    assert_same_neighbours(r_p, d_p, r_j, d_j, rtol=GATHER_RTOL, atol=1e-5)
    d2 = np.sqrt(((q[:, None, :].astype(np.float64)
                   - lay["dq"][None]) ** 2).sum(-1))
    ref = np.argsort(d2, axis=1)[:, :8]
    assert_same_neighbours(r_p, d_p, ref, np.take_along_axis(d2, ref, 1),
                           rtol=1e-4, atol=1e-4)


def test_virtual_tiled_query_faithful_nprobe():
    # :98-126: the nprobe nearest ORIGINAL lists, exactly their rows.
    lay = chunked_tiled_layout(seed=7)
    q = near_rows(lay["dq"], 8, seed=2)
    k, nprobe = 4, 3
    budget = ivf_scan.probe_budget(lay["csr"][3], nprobe)
    d_p, r_p, d_j, r_j = _virtual_query(lay, q, k, budget, nprobe)
    assert_same_neighbours(r_p, d_p, r_j, d_j, rtol=GATHER_RTOL, atol=1e-5)
    c_d2 = ((q[:, None, :].astype(np.float64)
             - lay["cents"][None]) ** 2).sum(-1)
    for i in range(q.shape[0]):
        cand = np.flatnonzero(
            np.isin(lay["assigns"], np.argsort(c_d2[i])[:nprobe]))
        dist = np.sqrt(((q[i].astype(np.float64)
                         - lay["dq"][cand]) ** 2).sum(-1))
        np.testing.assert_array_equal(r_p[i], cand[np.argsort(dist)][:k])
        np.testing.assert_allclose(d_p[i], np.sort(dist)[:k], rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("rerank", ["gather", "score"])
def test_virtual_tiled_query_equals_table_form(rerank):
    # :129-145: the slot-table form over the original centroids selects
    # the same windows (no centroid ties on random data), so both forms
    # give the same rows and distances bit for bit.
    lay = chunked_tiled_layout(n_chunks=3, seed=13)
    q = near_rows(lay["dq"], 8, seed=4)
    k, nprobe = 8, 3
    v_tile, v_col, v_len, v_orig, _ = lay["csr"]
    budget = ivf_scan.probe_budget(v_orig, nprobe)
    d_p, r_p, d_j, r_j = _virtual_query(lay, q, k, budget, nprobe, rerank)
    if rerank == "gather":
        assert_same_neighbours(r_p, d_p, r_j, d_j, rtol=GATHER_RTOL,
                               atol=1e-5)
    else:
        # The TPU kernel's split-bf16 surrogate against the plain
        # version's f32 one: the bound of test_tiled_table_query_matches_jax
        # on the squared distance, over 2 d at the first distance.
        rq = (q - lay["b"]).astype(np.float64)
        for i in range(q.shape[0]):
            tol2 = 4.0 * 2.0 ** -16 * ((rq[i] ** 2).sum()
                                       + lay["s2t"].max())
            assert_same_neighbours(r_p[i:i + 1], d_p[i:i + 1],
                                   r_j[i:i + 1], d_j[i:i + 1], rtol=0.0,
                                   atol=tol2 / max(2.0 * d_j[i, 0], 1e-6))
    table = ivf_scan.build_slot_table(v_orig, lay["cents"].shape[0])
    d_t, r_t = ivf_scan.ivf_query_dma_tiled_table(
        *(_t(x) for x in (lay["db3"], lay["s2t"], lay["a"], lay["b"],
                          lay["cents"])), _t(table).long(), _t(v_tile),
        _t(v_col), _t(v_len), _t(q), k=k, nprobe_orig=nprobe, rerank=rerank)
    np.testing.assert_array_equal(r_t.numpy(), r_p)
    np.testing.assert_array_equal(d_t.numpy(), d_p)
