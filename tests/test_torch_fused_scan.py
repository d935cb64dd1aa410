"""
The port's fused scan (``smqtk_indexing_tpu_torch/ops/fused_scan.py``)
against the JAX package's ``ops/pallas_scan.py`` (interpret mode, exact
``precision="highest"``) and a float64 oracle. Inputs are made with numpy
from a seed and fed to both. On the CPU the port runs the kernel's plain
PyTorch version; the kernel itself is checked on the card by
``tests/test_torch_cuda.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops import pallas_scan as jax_scan
from smqtk_indexing_tpu_torch.ops import _kernels, fused_scan
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
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(
        _torch_db(db, dtype), torch.from_numpy(sq), torch.from_numpy(pen),
        torch.from_numpy(q), precision="highest").numpy()
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
        db_norm=torch.from_numpy(norm), precision="highest")
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
    # Stage 2's plain version (the CPU route) runs in query blocks under
    # STAGE2_BYTES: blocking must not change the answer.
    n, d, b, k = 2048, 128, 24, 6
    db, sq, pen, q, valid = scan_inputs(n, d, b, seed=4)
    t = [torch.from_numpy(a) for a in (db, sq, pen, q, valid)]
    sid = fused_scan.select_segments(
        fused_scan.segment_minima(t[0], t[1], t[2], t[3]), 16)
    whole = fused_scan.rerank_segments_reference(t[0], t[4], t[3], sid, k=k)
    # 5 queries a block.
    monkeypatch.setattr(fused_scan, "STAGE2_BYTES", 5 * 16 * 128 * d * 4)
    blocked = fused_scan.rerank_segments(t[0], t[4], t[3], sid, k=k)
    torch.testing.assert_close(blocked[0], whole[0], rtol=0, atol=0)
    torch.testing.assert_close(blocked[1], whole[1], rtol=0, atol=0)


@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_rerank_segments_takes_the_plain_version_on_cpu(metric):
    # A CPU tensor takes rerank_segments_reference: the same answer, and no
    # kernel launch counted.
    n, d, b, k = 2048, 32, 12, 5
    db, sq, pen, q, valid = scan_inputs(n, d, b, seed=9)
    t = [torch.from_numpy(a) for a in (db, sq, pen, q, valid)]
    norm = torch.sqrt(t[1])
    sid = fused_scan.select_segments(
        fused_scan.segment_minima(t[0], t[1], t[2], t[3]), 13)
    before = dict(fused_scan.LAUNCHES)
    got = fused_scan.rerank_segments(t[0], t[4], t[3], sid, k=k,
                                     metric=metric, db_norm=norm)
    assert fused_scan.LAUNCHES == before
    want = fused_scan.rerank_segments_reference(t[0], t[4], t[3], sid, k=k,
                                                metric=metric, db_norm=norm)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    with pytest.raises(ValueError, match="unsupported device"):
        fused_scan.rerank_segments(t[0].to("meta"), t[4], t[3], sid, k=k)


@pytest.mark.parametrize("b, m, blocks", [
    (1024, 18 * 128, 1),             # the GIST1M and Deep10M cells
    (16, 18 * 128, 1),               # B = 16
    (1024, 100_008 * 128, 205),      # k = 100,000 (LSH n_codes): 5 a block
    (3, 1 << 27, 3),                 # a query past the cap: one a block
    (0, 18 * 128, 0)])
def test_stage2_query_blocks(b, m, blocks):
    # The card's stage 2 cuts the batch only where its (b, m) f32
    # distances would pass STAGE2_BYTES; the blocks tile the batch in
    # order.
    got = fused_scan.stage2_query_blocks(b, m)
    assert len(got) == blocks
    edges = [0] + [hi for _, hi in got]
    assert [lo for lo, _ in got] == edges[:-1] and edges[-1] == b
    for lo, hi in got:
        assert hi > lo
        assert 4 * (hi - lo) * m <= fused_scan.STAGE2_BYTES or hi - lo == 1


@pytest.mark.parametrize("case, error, match", [
    ("metric", ValueError, "serves"),
    ("dtype", TypeError, "float32 or bfloat16"),
    ("width", ValueError, "multiple of 4"),
    ("aligned", ValueError, "16-byte aligned"),
    ("rows", ValueError, "multiple of 128"),
    ("shape", ValueError, "must be"),
    ("valid", ValueError, "valid"),
    ("norm", ValueError, "db_norm"),
    ("devices", ValueError, "several devices"),
    ("contiguous", ValueError, "contiguous")])
def test_rerank_segments_checks_what_the_kernel_takes(case, error, match):
    # The card's launcher refuses, before any launch, what
    # csrc/rerank_segments.cu cannot take; each case breaks one thing.
    d = 18 if case == "width" else 32
    n = 200 if case == "rows" else 256
    db = torch.zeros((n, d), dtype=torch.int8 if case == "dtype"
                     else torch.float32)
    if case == "contiguous":
        db = torch.zeros((n, 2 * d))[:, :d]
    if case == "aligned":
        db = torch.zeros(n * d + 1)[1:].view(n, d)
    valid = torch.ones(n, dtype=torch.uint8 if case == "valid"
                       else torch.bool)
    q = torch.zeros((4, d + (1 if case == "shape" else 0)))
    sid = torch.zeros((4, 2), dtype=torch.int64)
    metric = {"metric": "hik", "norm": "cosine"}.get(case, "euclidean")
    norm = torch.ones(n, device="meta" if case == "devices" else "cpu")
    if case == "devices":
        metric = "cosine"
    with pytest.raises(error, match=match):
        fused_scan._check_rerank(db, valid, q, sid, metric,
                                 None if case == "norm" else norm)


@pytest.mark.parametrize("d", [4224, 8192, 16512, 40960])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rerank_segments_check_takes_any_padded_width(dtype, d):
    # No width limit: rows past the kernel's 32 KB tiles are cut into
    # slabs, and queries that do not fit in shared memory are read from
    # global memory, so every width pad_dim gives is taken.
    n = 256
    db = torch.empty((n, d), dtype=dtype)
    fused_scan._check_rerank(db, torch.ones(n, dtype=torch.bool),
                             torch.empty((4, d)),
                             torch.zeros((4, 2), dtype=torch.int64),
                             "euclidean", None)


def test_rerank_kernel_constants_follow_the_source():
    # The launcher's limits and entry points are the kernel source's.
    src = (_kernels.CSRC / "rerank_segments.cu").read_text()
    assert int(re.search(r"kSeg = (\d+);", src).group(1)) == fused_scan.SEG
    for name, code in fused_scan._RERANK_METRIC.items():
        camel = "k" + "".join(w.title() for w in name.split("_"))
        assert f"{camel} = {code}" in src
    assert "rerank_segments.cu" in _kernels.SOURCES
    for entry in ("rerank_segments_f32", "rerank_segments_bf16"):
        assert len(re.findall(rf'^extern "C" int {entry}\(', src,
                              re.M)) == 1
        assert entry in _kernels._ENTRY_POINTS
    assert {form for (w, form) in fused_scan.LAUNCHES
            if w == "rerank_segments"} == {"f32", "bf16"}


@pytest.mark.parametrize("b", [64, 40])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_flat_topk_fused_bf16_stage2_matches_jax(metric, b):
    # db_seg_lo (pallas_scan.py:702-755) on the cases of the JAX test
    # tests/ops/test_pallas_scan.py:144-170: B = 64 takes two 32-query
    # cohorts, B = 40 the per-query product. Both sides re-score the
    # winners exactly in f32, so the distances agree to DIST_RTOL.
    n, d, k = 8192, 128, 10
    db, sq, _, q, valid = scan_inputs(n, d, b, seed=5)
    norm = np.sqrt(sq)
    seg_lo = db.reshape(n // 128, 128, d)
    kw_j = {"db_norm": jnp.asarray(norm)}
    kw_p = {"db_norm": torch.from_numpy(norm)}
    if metric == "cosine":
        unit = db / np.where(norm == 0, 1, norm)[:, None]
        kw_j["db_t"] = jnp.asarray(np.ascontiguousarray(unit.T))
    d_ref, r_ref = jax_scan.flat_topk_fused(
        jnp.asarray(db), jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(q), k=k, metric=metric, interpret=True,
        precision="highest", db_seg_lo=jnp.asarray(seg_lo, jnp.bfloat16),
        **kw_j)
    d_port, r_port = fused_scan.flat_topk_fused(
        torch.from_numpy(db), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), k=k, metric=metric, precision="highest",
        db_seg_lo=torch.from_numpy(seg_lo).to(torch.bfloat16), **kw_p)
    assert valid[r_port.numpy()].all()
    assert_same_neighbours(r_port, d_port, np.asarray(r_ref),
                           np.asarray(d_ref), rtol=DIST_RTOL, atol=1e-6)
    # The f32 stage 2 on the same inputs gives the same answer.
    d_f32, r_f32 = fused_scan.flat_topk_fused(
        torch.from_numpy(db), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), k=k, metric=metric, precision="highest",
        **kw_p)
    assert_same_neighbours(r_port, d_port, r_f32, d_f32, rtol=DIST_RTOL,
                           atol=1e-6)


@pytest.mark.parametrize("b", [32, 24])
def test_flat_topk_fused_bf16_stage2_exact_vs_float64(b):
    # A bf16 store passes its own rows as the mirror: the answer is the
    # float64 top-k over the stored (bf16) rows, rows identical.
    n, d, k = 4096, 64, 8
    rng = np.random.default_rng(6)
    db = torch.from_numpy((rng.normal(size=(n, d)) * 3).astype(np.float32)) \
        .to(torch.bfloat16)
    q = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    x = db.float().numpy().astype(np.float64)
    sq = torch.from_numpy((x * x).sum(1).astype(np.float32))
    dist, rows = fused_scan.flat_topk_fused(
        db, sq, torch.ones(n, dtype=torch.bool), torch.from_numpy(q), k=k,
        db_seg_lo=db.view(n // 128, 128, d))
    d2 = ((q.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
    ref_rows = np.argsort(d2, axis=1)[:, :k]
    np.testing.assert_array_equal(rows.numpy(), ref_rows)
    np.testing.assert_allclose(
        dist.numpy(), np.sqrt(np.take_along_axis(d2, ref_rows, 1)),
        rtol=DIST_RTOL)


def test_bf16_stage2_blocks_queries(monkeypatch):
    # Query blocks of whole cohorts under STAGE2_BYTES give the same
    # answer as one block.
    n, d, b, k = 2048, 64, 96, 6
    db, sq, pen, q, valid = scan_inputs(n, d, b, seed=7)
    t = [torch.from_numpy(a) for a in (db, sq, pen, q, valid)]
    lo = t[0].to(torch.bfloat16).view(n // 128, 128, d)
    sid = fused_scan.select_segments(
        fused_scan.segment_minima(t[0], t[1], t[2], t[3]), 16)
    args = (t[0], lo, t[1], t[4], t[3], t[3], sid)
    kw = dict(k=k, metric="euclidean", db_norm=None, rerank_margin=16)
    whole = fused_scan.rerank_segments_bf16(*args, **kw)
    monkeypatch.setattr(fused_scan, "STAGE2_BYTES", 1)
    blocked = fused_scan.rerank_segments_bf16(*args, **kw)
    torch.testing.assert_close(blocked[0], whole[0], rtol=0, atol=0)
    torch.testing.assert_close(blocked[1], whole[1], rtol=0, atol=0)
