"""
The port's hand-written kernels on the card (K1 ``segment_minima`` with
its exact f32 form, its split3 and native f32 forms and its bf16 and
int8-code forms on the tensor cores, K7
``ivf_list_scores_tiled``, K6 ``ivf_list_scores``, K3 ``seg_gather_tiled``, K8
``ivf_list_scores_tiled_pq``, K2, K4 and K5 over int8 codes on the tensor
cores (``csrc/segment_minima_tiled_wgmma.cu``) and over f32 and bf16
(``csrc/segment_minima_tiled.cu``), the int8 x int8 forms of K1, K2, K4 and
K5 on the tensor cores (``wgmma`` s8, bit for bit), and the probes K10 and
K9 of ``smqtk_indexing_tpu_torch/tools/``),
against their plain PyTorch versions and against the port's CPU path, for
the flat and the IVF indexes and the capacity scan; and the hashing slice:
the code store's ±1 route (K1's bf16 form) against its XOR route and a
numpy popcount, the XOR route on the card against the CPU, and the LSH
index's serves on the card against the CPU. Every test here is marked
``cuda`` and skips without a card. This file imports neither jax nor the
JAX package's compute, so it runs on a machine with the card and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q -m cuda \\
        tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.ops import fused_scan
from tests.test_torch_helpers import (
    assert_same_neighbours, chunked_tiled_layout, near_rows, scan_inputs,
)

torch.set_num_threads(1)

#: K1 vs its plain version and float64: every form's products are exact
#: (f32 FFMA; bf16 x bf16 or bf16 x int8 on the tensor cores, the f32
#: forms' products of bf16 parts included), summed in f32 in different
#: orders, so each (query, segment) minimum agrees within STAGE1_RTOL of
#: the largest sum of absolute terms |db_sq| + 2 |q| . |x| over the
#: segment's rows.
STAGE1_RTOL = 1e-5
#: Distances, card vs CPU: exact f32 formulas in different orders.
DIST_RTOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _launched(before: dict) -> dict:
    """The launches of ``fused_scan``'s kernels since ``before`` (a copy
    of ``fused_scan.LAUNCHES``), by (wrapper, form)."""
    return {key: n - before[key] for key, n in fused_scan.LAUNCHES.items()
            if n != before[key]}


def _f64_parts(t: torch.Tensor, precision: str) -> list:
    """An f32 operand as float64 pieces whose products the form sums:
    itself (``highest``), or its bf16 hi (``native``) and hi and lo
    (``split3``) parts."""
    if precision == "highest":
        return [t.double()]
    hi, lo = fused_scan.split_bf16(t.float())
    return [hi.double()] if precision == "native" \
        else [hi.double(), lo.double()]


def _assert_stage1(out, ref, db, sq, pen, q, precision="highest"):
    """K1's output against its plain version ``ref`` and float64 on the
    operands the kernel sees (the bf16-rounded query over a bf16 or int8
    database; over an f32 database the products of ``precision``'s bf16
    parts: qh.xh for native, qh.xh + qh.xl + ql.xh for split3), within
    STAGE1_RTOL of each segment's largest sum of absolute terms; +inf
    where float64 has it."""
    if db.dtype == torch.float32:
        qs, xs = _f64_parts(q, precision), _f64_parts(db, precision)
        pairs = [(0, 0), (0, 1), (1, 0)][:2 * len(qs) - 1]
    else:
        qs, xs = [q.to(torch.bfloat16).double()], [db.double()]
        pairs = [(0, 0)]
    b, n = q.shape[0], db.shape[0]
    ip = sum(qs[i] @ xs[j].T for i, j in pairs)
    mag = sum(qs[i].abs() @ xs[j].abs().T for i, j in pairs)
    exact = ((sq.double() - 2.0 * ip) + pen.double()) \
        .view(b, n // 128, 128).amin(-1)
    mag = (sq.double().abs() + 2.0 * mag).view(b, n // 128, 128).amax(-1)
    assert torch.equal(torch.isinf(out), torch.isinf(exact))
    assert torch.equal(torch.isinf(ref), torch.isinf(exact))
    fin = torch.isfinite(exact)
    tol = STAGE1_RTOL * mag[fin]
    assert ((out.double() - exact)[fin].abs() <= tol).all()
    assert ((out.double() - ref.double())[fin].abs() <= tol).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_matches_plain_version(card, dtype):
    # The f32 form here is the exact one, "highest" (FFMA); a bf16
    # database ignores the precision.
    n, d, b = 4096, 256, 200  # a ragged query tile (200 = 128 + 72)
    db, sq, pen, q, _ = scan_inputs(n, d, b, seed=5)
    args = (torch.from_numpy(db).to(card, getattr(torch, dtype)),
            torch.from_numpy(sq).to(card), torch.from_numpy(pen).to(card),
            torch.from_numpy(q).to(card))
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(*args, precision="highest")
    torch.cuda.synchronize()
    form = "ffma" if dtype == "float32" else "wgmma"
    assert _launched(before) == {("segment_minima", form): 1}
    ref = fused_scan.segment_minima_reference(*args, precision="highest")
    assert _launched(before) == {("segment_minima", form): 1}
    assert torch.isinf(out[:, 1]).all()
    _assert_stage1(out, ref, *args)


def _wgmma_inputs(b, n, d, dtype, card, seed):
    """K1's bf16 or int8-code operands: dead rows, rows 128-255 dead (one
    wholly dead segment, when n > 128), and for int8 codes rows of -128
    and of 127."""
    rng = np.random.default_rng(seed)
    pen = np.where(rng.random(n) < 0.03, np.inf, 0.0).astype(np.float32)
    pen[128:256] = np.inf
    if dtype == "int8":
        codes = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
        codes[0] = -128
        codes[min(1, n - 1)] = 127
        codes[n // 2] = -128
        a = (rng.random(d) * 0.02 + 0.001).astype(np.float32)
        sq = ((codes.astype(np.float64) * a) ** 2).sum(1).astype(np.float32)
        q = (rng.normal(size=(b, d)) * a * 60).astype(np.float32)
        db = torch.from_numpy(codes).to(card)
    else:
        x = (rng.normal(size=(n, d)) * 3).astype(np.float32)
        db = torch.from_numpy(x).to(card, torch.bfloat16)
        sq = np.einsum("ij,ij->i", x, x).astype(np.float32)
        q = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    return (db, torch.from_numpy(sq).to(card), torch.from_numpy(pen).to(card),
            torch.from_numpy(q).to(card))


#: K1's wgmma forms: (B, N, d). The strip is 32 segments, so N = 128 * 40
#: and 128 * 36 leave a ragged last strip; B = 1, 65 and 200 ragged query
#: tiles; d = 512 takes the 128-query resident tile, d = 1024 streams the
#: query through the ring.
WGMMA_CASES = {"one_block": (64, 128, 128),
               "b1": (1, 128 * 40, 128),
               "b65": (65, 128 * 40, 128),
               "b200": (200, 128 * 40, 128),
               "d256": (200, 128 * 36, 256),
               "d512": (200, 128 * 36, 512),
               "d1024": (200, 128 * 36, 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int8"])
@pytest.mark.parametrize("case", list(WGMMA_CASES))
def test_k1_wgmma_forms_match_plain_and_f64(card, case, dtype):
    b, n, d = WGMMA_CASES[case]
    args = _wgmma_inputs(b, n, d, dtype, card, seed=len(case) * 7 + b)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima", "wgmma"): 1}
    assert out.shape == (b, n // 128)
    ref = fused_scan.segment_minima_reference(*args)
    if n > 256:
        assert torch.isinf(out[:, 1]).all()
    _assert_stage1(out, ref, *args)


def _f32_inputs(b, n, d, kind, card, seed):
    """K1's f32 operands: dead rows, rows 128-255 dead (one wholly dead
    segment, when n > 128). ``kind``: "normal" (N(0, 3) rows and queries),
    "small" (rows scaled by 2^-120, so that most lo parts are bf16
    subnormals, and some hi parts too) or "cosine" (unit rows and queries,
    zero norms: cosine's stage 1)."""
    rng = np.random.default_rng(seed)
    pen = np.where(rng.random(n) < 0.03, np.inf, 0.0).astype(np.float32)
    pen[128:256] = np.inf
    x = rng.normal(size=(n, d)) * 3
    q = rng.normal(size=(b, d)) * 3
    if kind == "small":
        x = x * 2.0 ** -120
    if kind == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    x, q = x.astype(np.float32), q.astype(np.float32)
    sq = np.zeros(n, np.float32) if kind == "cosine" \
        else np.einsum("ij,ij->i", x, x).astype(np.float32)
    return tuple(torch.from_numpy(a).to(card) for a in (x, sq, pen, q))


#: K1's f32 forms on the tensor cores: (B, N, d), as WGMMA_CASES. split3
#: keeps 256 queries resident at d = 128 and 128 at d = 256, and streams
#: the query above; native keeps 256 to d = 384, 128 to d = 768.
F32_CASES = {"one_block": (64, 128, 128),
             "b1": (1, 128 * 40, 128),
             "b65": (65, 128 * 40, 128),
             "b200": (200, 128 * 40, 128),
             "b256": (256, 128 * 40, 128),
             "d256": (200, 128 * 36, 256),
             "d512": (256, 128 * 36, 512),
             "d1024": (200, 128 * 36, 1024)}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["normal", "small", "cosine"])
@pytest.mark.parametrize("precision", ["split3", "native"])
@pytest.mark.parametrize("case", list(F32_CASES))
def test_k1_f32_forms_match_plain_and_f64(card, case, precision, kind):
    b, n, d = F32_CASES[case]
    args = _f32_inputs(b, n, d, kind, card, seed=len(case) * 11 + b)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(*args, precision=precision)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima", f"wgmma_{precision}"): 1}
    assert out.shape == (b, n // 128)
    ref = fused_scan.segment_minima_reference(*args, precision=precision)
    if n > 256:
        assert torch.isinf(out[:, 1]).all()
    _assert_stage1(out, ref, *args, precision)
    if precision == "split3" and kind != "small":
        # The split's own error: within STAGE1_RTOL of the exact f32
        # operands' float64 minima too (the dropped ql.xl is below 2^-16
        # of |q| . |x|). Bf16 subnormal lo parts keep fewer bits.
        _assert_stage1(out, ref, *args, "highest")


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["split3", "native"])
def test_k1_f32_forms_refuse_a_depth_they_cannot_take(card, precision):
    db = torch.zeros((256, 64), device=card)
    vec = torch.zeros(256, device=card)
    before = dict(fused_scan.LAUNCHES)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_scan.segment_minima(db, vec, vec,
                                  torch.zeros((4, 64), device=card),
                                  precision=precision)
    with pytest.raises(ValueError, match="precision"):
        fused_scan.segment_minima(db, vec, vec,
                                  torch.zeros((4, 64), device=card),
                                  precision="split4")
    assert _launched(before) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("stage1, form", [(None, "wgmma_split3"),
                                          ("split3", "wgmma_split3"),
                                          ("native", "wgmma_native"),
                                          ("highest", "ffma")])
def test_flat_store_takes_smqtk_tpu_stage1(card, monkeypatch, stage1, form):
    # The f32 store reads SMQTK_TPU_STAGE1 on each query: split3 by
    # default, highest on the FFMA kernel; the results equal the CPU
    # path's under the same mode (stage 2 is exact f32 in both).
    rng = np.random.default_rng(9)
    x = (rng.random((5000, 96), dtype=np.float32) * 218.0)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(5000)]
    if stage1 is None:
        monkeypatch.delenv("SMQTK_TPU_STAGE1", raising=False)
    else:
        monkeypatch.setenv("SMQTK_TPU_STAGE1", stage1)
    results = []
    for device in ("cuda", "cpu"):
        index = FlatNearestNeighborsIndex(device=device)
        index.build_index(els)
        before = dict(fused_scan.LAUNCHES)
        results.append(index.nn_many(els[:64], 10))
        launched = _launched(before)
        assert launched == ({("segment_minima", form): 1,
                             ("rerank_segments", "f32"): 1}
                            if device == "cuda" else {})
    for r_gpu, r_cpu in zip(*results):
        assert r_gpu[0][0].uuid() == r_cpu[0][0].uuid()
        np.testing.assert_allclose(r_gpu[1], r_cpu[1], rtol=DIST_RTOL,
                                   atol=1e-6)
        assert r_gpu[1][0] == 0.0


@pytest.mark.cuda
def test_kernel_wrapper_rejects_what_the_kernel_cannot_take(card):
    db = torch.zeros((256, 64), device=card)
    vec = torch.zeros(256, device=card)
    with pytest.raises(ValueError, match="multiple of 128"):
        fused_scan.segment_minima(db, vec, vec,
                                  torch.zeros((4, 64), device=card))
    db = torch.zeros((256, 256), device=card)[:, :128]
    with pytest.raises(ValueError, match="contiguous"):
        fused_scan.segment_minima(db, vec, vec,
                                  torch.zeros((4, 128), device=card))
    with pytest.raises(ValueError, match="several devices"):
        fused_scan.segment_minima(db.contiguous(), vec.cpu(), vec,
                                  torch.zeros((4, 128), device=card))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_flat_topk_fused_matches_cpu(card, metric):
    n, d, b, k = 8192, 128, 64, 10
    db, sq, _, q, valid = scan_inputs(n, d, b, seed=6)
    norm = np.sqrt(sq)
    cpu = [torch.from_numpy(a) for a in (db, sq, valid, q)]
    d_cpu, r_cpu = fused_scan.flat_topk_fused(
        *cpu, k=k, metric=metric, db_norm=torch.from_numpy(norm))
    d_gpu, r_gpu = fused_scan.flat_topk_fused(
        *(t.to(card) for t in cpu), k=k, metric=metric,
        db_norm=torch.from_numpy(norm).to(card))
    np.testing.assert_allclose(d_gpu.cpu().numpy(), d_cpu.numpy(),
                               rtol=DIST_RTOL, atol=1e-6)
    same = (r_gpu.cpu() == r_cpu).float().mean().item()
    assert same >= 0.99  # only near-tie swaps may differ


@pytest.mark.cuda
@pytest.mark.parametrize("d", [100, 4224, 8192])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flat_index_on_card_matches_cpu(card, dtype, d):
    # d = 4,224 and 8,192: rows past 4 KB, which the stage-2 kernel's wide
    # layouts serve.
    rng = np.random.default_rng(7)
    x = rng.random((3000, d), dtype=np.float32)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(3000)]
    results = []
    for device in ("cuda", "cpu"):
        index = FlatNearestNeighborsIndex(dtype=dtype, device=device)
        index.build_index(els[:2500])
        index.update_index(els[2500:])
        index.remove_from_index(list(range(0, 3000, 7)))
        before = dict(fused_scan.LAUNCHES)
        res = index.nn_many(els[1:40:2], 5)
        launched = _launched(before)
        assert bool(launched) == (device == "cuda")
        # The f32 store's default stage 1 is split3 on the tensor cores;
        # stage 2 is the rows' own form of the re-rank kernel.
        form = "wgmma_split3" if dtype == "float32" else "wgmma"
        rows = "f32" if dtype == "float32" else "bf16"
        assert set(launched) <= {("segment_minima", form),
                                 ("rerank_segments", rows)}
        assert (("rerank_segments", rows) in launched) == (device == "cuda")
        results.append(res)
    for r_gpu, r_cpu in zip(*results):
        assert [e.uuid() for e in r_gpu[0]] == [e.uuid() for e in r_cpu[0]]
        np.testing.assert_allclose(r_gpu[1], r_cpu[1], rtol=DIST_RTOL,
                                   atol=1e-6)
    report = FlatNearestNeighborsIndex.usability_report()
    assert report["kernel_tier"] == "cuda" and report["degraded"] is False


@pytest.mark.cuda
def test_full_f32_policy_belongs_to_the_caller(card):
    db, sq, pen, q, valid = scan_inputs(1024, 128, 8, seed=8)
    db, sq, pen, q, valid = (torch.from_numpy(a).to(card)
                             for a in (db, sq, pen, q, valid))
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        # The plain version's cuBLAS product refuses TF32 ...
        with pytest.raises(RuntimeError, match="allow_tf32"):
            fused_scan.segment_minima_reference(db, sq, pen, q)
        # ... while the fused path has no cuBLAS product and leaves the
        # caller's switch as it was.
        fused_scan.flat_topk_fused(db, sq, valid, q, k=5,
                                   metric="inner_product")
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


# ---------------------------------------------------------------------------
# Stage 2: rerank_segments (csrc/rerank_segments.cu)
# ---------------------------------------------------------------------------

#: Stage 2 against float64 and its plain version: exact f32 distances whose
#: sums run in another order.
STAGE2_RTOL = 1e-6


def _stage2_inputs(card, d, k, dtype, b=40, seed=0, extra=24):
    """Rows (non-negative, so no product cancels), liveness (3% dead rows,
    segment 2 wholly dead), queries, row norms and each query's k + 8
    distinct kept segments, the last two -1 in the first three queries;
    all on the card."""
    rng = np.random.default_rng(seed)
    s_keep = k + 8
    nseg = s_keep + extra
    n = nseg * 128
    x = rng.random((n, d), dtype=np.float32)
    q = rng.random((b, d), dtype=np.float32)
    valid = rng.random(n) > 0.03
    valid[2 * 128:3 * 128] = False
    sid = np.stack([rng.permutation(nseg)[:s_keep] for _ in range(b)])
    sid[:3, -2:] = -1
    db = torch.from_numpy(x).to(card, getattr(torch, dtype))
    return (db, torch.from_numpy(valid).to(card), torch.from_numpy(q).to(card),
            db.float().norm(dim=1), torch.from_numpy(sid).to(card))


def _f64_dists(db, qi, rows, metric, norm):
    """Float64 distances of ``rows`` to the query ``qi`` under ``metric``
    (the stored rows, bf16 ones widened exactly)."""
    x, qd = db[rows].double(), qi.double()
    if metric == "euclidean":
        return (x - qd).square().sum(-1).sqrt()
    if metric == "inner_product":
        return -(x @ qd)
    den = qd.norm() * norm[rows].double()
    sim = torch.clamp((x @ qd) / torch.where(den == 0, 1.0, den), -1.0, 1.0)
    return 2.0 * torch.arccos(sim) / math.pi


def _held(dist, metric):
    """Distances as float64 in the form STAGE2_RTOL holds: cosine's as
    the similarity cos(pi d / 2), since the arccos of an f32 sum amplifies
    its rounding at small angles (by 1 / angle^2, relatively) in every
    f32 implementation alike; +inf stays."""
    dist = torch.as_tensor(dist).double()
    if metric != "cosine":
        return dist.numpy()
    return torch.where(torch.isinf(dist), dist,
                       torch.cos(dist * (math.pi / 2))).numpy()


def _assert_stage2(db, valid, q, sid, k, metric, norm, d_k, r_k):
    """The kernel's answer against its plain version and float64 over
    every live kept row: sorted distances within STAGE2_RTOL (cosine's as
    similarities, :func:`_held`), the row sets equal but for ties, +inf /
    -1 past the live rows, and each returned row's own float64 distance."""
    d_ref, r_ref = fused_scan.rerank_segments_reference(
        db, valid, q, sid, k=k, metric=metric, db_norm=norm)
    b = q.shape[0]
    d64 = torch.full((b, k), math.inf, dtype=torch.float64)
    r64 = torch.full((b, k), -1, dtype=torch.int64)
    own = torch.full((b, k), math.inf, dtype=torch.float64)
    lanes = torch.arange(128, device=db.device)
    for i in range(b):
        kept = sid[i][sid[i] >= 0]
        rows = (kept[:, None] * 128 + lanes).reshape(-1)
        rows = rows[valid[rows]]
        dd = _f64_dists(db, q[i], rows, metric, norm)
        top, at = torch.topk(dd, min(k, dd.numel()), largest=False)
        d64[i, :top.numel()] = top.cpu()
        r64[i, :top.numel()] = rows[at].cpu()
        got = r_k[i][r_k[i] >= 0]
        own[i, :got.numel()] = _f64_dists(db, q[i], got, metric, norm).cpu()
    d_k, r_k = d_k.cpu(), r_k.cpu()
    assert torch.equal(torch.isinf(d_k), torch.isinf(d64))
    assert torch.equal(r_k < 0, torch.isinf(d_k))
    held = _held(d_k, metric)
    assert_same_neighbours(r_k.numpy(), held, r_ref.cpu().numpy(),
                           _held(d_ref.cpu(), metric), STAGE2_RTOL)
    assert_same_neighbours(r_k.numpy(), held, r64.numpy(),
                           _held(d64, metric), STAGE2_RTOL)
    np.testing.assert_allclose(held, _held(own, metric), rtol=STAGE2_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("d", [16, 128, 960])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_rerank_segments_matches_plain_version_and_f64(card, metric, dtype,
                                                       d, k):
    db, valid, q, norm, sid = _stage2_inputs(card, d, k, dtype)
    before = dict(fused_scan.LAUNCHES)
    d_k, r_k = fused_scan.rerank_segments(db, valid, q, sid, k=k,
                                          metric=metric, db_norm=norm)
    torch.cuda.synchronize()
    rows = "f32" if dtype == "float32" else "bf16"
    assert _launched(before) == {("rerank_segments", rows): 1}
    _assert_stage2(db, valid, q, sid, k, metric, norm, d_k, r_k)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b", [3, 300])
def test_rerank_segments_edge_cases(card, dtype, b):
    # One segment kept by every query of the batch (segment 7, first slot),
    # a query whose every slot is -1 (all +inf, rows -1), -1 slots, dead
    # rows and a wholly dead segment; B = 3 runs windows of one pair, B =
    # 300 windows of several pairs on one segment.
    k, d = 10, 128
    db, valid, q, norm, sid = _stage2_inputs(card, d, k, dtype, b=b, seed=b)
    others = sid[:, 1:].clone()
    others[others == 7] = 2          # segment 2 is wholly dead
    sid = torch.cat([torch.full_like(sid[:, :1], 7), others], dim=1)
    sid[1] = -1
    valid[7 * 128:7 * 128 + 40] = False
    d_k, r_k = fused_scan.rerank_segments(db, valid, q, sid, k=k,
                                          db_norm=norm)
    torch.cuda.synchronize()
    assert torch.isinf(d_k[1]).all() and (r_k[1] == -1).all()
    _assert_stage2(db, valid, q, sid, k, "euclidean", norm, d_k, r_k)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine"])
def test_rerank_segments_cuts_query_blocks(card, monkeypatch, metric):
    # A (b, s_keep * 128) distance buffer past STAGE2_BYTES is cut into
    # query blocks of that many bytes, a launch each, with the same
    # answers as one block.
    k, d, b = 10, 128, 40
    db, valid, q, norm, sid = _stage2_inputs(card, d, k, "float32", b=b)
    whole = fused_scan.rerank_segments(db, valid, q, sid, k=k, metric=metric,
                                       db_norm=norm)
    m = sid.shape[1] * 128
    monkeypatch.setattr(fused_scan, "STAGE2_BYTES", 7 * 4 * m)
    assert len(fused_scan.stage2_query_blocks(b, m)) == 6
    before = dict(fused_scan.LAUNCHES)
    d_k, r_k = fused_scan.rerank_segments(db, valid, q, sid, k=k,
                                          metric=metric, db_norm=norm)
    torch.cuda.synchronize()
    assert _launched(before) == {("rerank_segments", "f32"): 6}
    assert_same_neighbours(r_k.cpu().numpy(), d_k.cpu().numpy(),
                           whole[1].cpu().numpy(), whole[0].cpu().numpy(),
                           STAGE2_RTOL)
    _assert_stage2(db, valid, q, sid, k, metric, norm, d_k, r_k)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [4224, 8192, 16512, 40960])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
def test_rerank_segments_at_wide_rows(card, metric, dtype, d):
    # Rows past 4 KB: the warps split each row (d = 4224 and bf16 8192),
    # a tile of one row (f32 8192), rows cut into 32 KB slabs, the last
    # one shorter (16512; bf16 40960), and queries too wide for shared
    # memory read from global memory (40960). 300 queries over 12
    # segments run windows of several pairs on one segment.
    k = 1
    db, valid, q, norm, sid = _stage2_inputs(card, d, k, dtype, b=300,
                                             extra=3)
    before = dict(fused_scan.LAUNCHES)
    d_k, r_k = fused_scan.rerank_segments(db, valid, q, sid, k=k,
                                          metric=metric, db_norm=norm)
    torch.cuda.synchronize()
    rows = "f32" if dtype == "float32" else "bf16"
    assert _launched(before) == {("rerank_segments", rows): 1}
    _assert_stage2(db, valid, q, sid, k, metric, norm, d_k, r_k)


@pytest.mark.cuda
def test_rerank_segments_rejects_what_the_kernel_cannot_take(card):
    sid = torch.zeros((4, 2), dtype=torch.int64, device=card)
    valid = torch.ones(256, dtype=torch.bool, device=card)
    q = torch.zeros((4, 18), device=card)
    with pytest.raises(ValueError, match="multiple of 4"):
        fused_scan.rerank_segments(torch.zeros((256, 18), device=card),
                                   valid, q, sid, k=1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fused_scan.rerank_segments(
            torch.zeros((256, 32), dtype=torch.int8, device=card), valid,
            torch.zeros((4, 32), device=card), sid, k=1)
    with pytest.raises(ValueError, match="several devices"):
        fused_scan.rerank_segments(torch.zeros((256, 32), device=card),
                                   valid.cpu(),
                                   torch.zeros((4, 32), device=card), sid,
                                   k=1)
    with pytest.raises(ValueError, match="db_norm"):
        fused_scan.rerank_segments(torch.zeros((256, 32), device=card),
                                   valid, torch.zeros((4, 32), device=card),
                                   sid, k=1, metric="cosine")


# ---------------------------------------------------------------------------
# IVF kernels: K7 (ivf_list_scores_tiled), K6 (ivf_list_scores), K3
# (seg_gather_tiled)
# ---------------------------------------------------------------------------

def _tiled_inputs(n_tiles, b, p, seed, d=128):
    """Random tiled codes, stats with dead rows (+inf), and probe windows:
    dead slots, windows clamped to the end of the last tile."""
    from smqtk_indexing_tpu_torch.ops.ivf_scan import TILE_ROWS, W_TILED
    rng = np.random.default_rng(seed)
    db3 = rng.integers(-127, 128, size=(n_tiles, d, TILE_ROWS)) \
        .astype(np.int8)
    s2t = (rng.random((n_tiles, 1, TILE_ROWS)) * 50).astype(np.float32)
    s2t[rng.random(s2t.shape) < 0.05] = np.inf
    t = rng.normal(size=(b, d)).astype(np.float32) * 0.05
    ti = rng.integers(0, n_tiles, size=(b, p)).astype(np.int32)
    c0 = (rng.integers(0, (TILE_ROWS - W_TILED) // 128 + 1, size=(b, p))
          * 128).astype(np.int32)
    ti[:, 0], c0[:, 0] = n_tiles - 1, TILE_ROWS - W_TILED   # last window
    lo = rng.integers(0, 128, size=(b, p)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 513, size=(b, p)),
                    W_TILED).astype(np.int32)
    hi[:, 0] = W_TILED
    hi[:, 1], ti[:, 1], c0[:, 1] = lo[:, 1], 0, 0               # dead
    return db3, s2t, t, ti, c0, lo, hi


@pytest.mark.cuda
def test_k7_matches_plain_version(card):
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    args = [torch.from_numpy(a).to(card)
            for a in _tiled_inputs(3, 37, 64, seed=11)]
    before = ivf_scan.LAUNCHES["ivf_list_scores_tiled"]
    out = ivf_scan.ivf_list_scores_tiled(*args)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled"] == before + 1
    ref = ivf_scan.ivf_list_scores_tiled_reference(*args)
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled"] == before + 1
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    assert torch.isinf(out[:, 1]).all()
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    assert (out - ref)[fin].abs().max().item() <= STAGE1_RTOL * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_k6_matches_plain_version(card, dtype):
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    n, d, b, p = 8192, 256, 19, 24
    rng = np.random.default_rng(12)
    if dtype == "int8":
        db = torch.from_numpy(rng.integers(-127, 128, size=(n, d))
                              .astype(np.int8))
        a = torch.from_numpy(rng.random(d).astype(np.float32) * 0.1)
    else:
        db = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
            .to(getattr(torch, dtype))
        a = torch.ones(d)
    t = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    starts = torch.from_numpy(
        rng.integers(0, (n - 512) // 32 + 1, size=(b, p)) * 32).int()
    starts[:, 0] = n - 512                                      # last window
    lo = torch.from_numpy(rng.integers(0, 32, size=(b, p))).int()
    hi = torch.clamp(lo + torch.from_numpy(
        rng.integers(0, 481, size=(b, p))).int(), max=512)
    hi[:, 1] = lo[:, 1]                                         # dead
    args = [x.to(card) for x in (db, t, a, starts, lo, hi)]
    before = ivf_scan.LAUNCHES["ivf_list_scores"]
    out = ivf_scan.ivf_list_scores(*args)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["ivf_list_scores"] == before + 1
    ref = ivf_scan.ivf_list_scores_reference(*args)
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    assert torch.isinf(out[:, 1]).all()
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    assert (out - ref)[fin].abs().max().item() <= STAGE1_RTOL * scale


def _k7_first_version(db3, s2t, t, ti, c0, lo, hi):
    """K7's output as its first version computes it (a block a slot,
    every column read): each column's sum_k t_k u_k as a chain of f32
    fmas in the order k = 0 .. d - 1 from 0.0, then ``s2 - 2 acc``. Each
    fma is emulated in float64, which holds ``acc + t_k u_k`` exactly
    (asserted), so one rounding to f32 gives the fma's result."""
    from smqtk_indexing_tpu_torch.ops.ivf_scan import W_TILED
    lane = torch.arange(W_TILED, device=db3.device)
    tt = ti.long()[..., None]
    cols = c0.long()[..., None] + lane
    acc = torch.zeros(cols.shape, dtype=torch.float64, device=db3.device)
    for k in range(db3.shape[1]):
        prod = t[:, k, None, None].double() * db3[tt, k, cols].double()
        s = acc + prod
        back = s - acc
        assert ((acc - (s - back)) + (prod - back) == 0).all()
        acc = s.float().double()
    scores = s2t[tt, 0, cols] - 2.0 * acc.float()
    ok = (lane >= lo[..., None]) & (lane < hi[..., None])
    return torch.where(ok, scores, math.inf)


def _k7_inputs(n_tiles, b, p, seed):
    """K7's operands with a quarter of the slots dead inside each query's
    run, query 1 (when there is one) without a live slot, and window
    edges anywhere, most of them off the 16-column chunks."""
    from smqtk_indexing_tpu_torch.ops.ivf_scan import W_TILED
    db3, s2t, t, ti, c0, lo, hi = _tiled_inputs(n_tiles, b, p, seed)
    rng = np.random.default_rng(seed + 1)
    dead = rng.random((b, p)) < 0.25
    dead[:, 0] = False
    hi[dead] = lo[dead]
    short = rng.random((b, p)) < 0.1                  # edges in one chunk
    short[:, 0] = False
    lo[short] = rng.integers(0, W_TILED - 16, size=short.sum())
    hi[short] = lo[short] + rng.integers(0, 17, size=short.sum())
    if b > 1:
        hi[1] = lo[1]
    return db3, s2t, t, ti, c0, lo, hi


def _k7_check(args):
    """K7 on the card: one launch, bit for bit its first version's output,
    and within 1e-5 of the largest score of its plain version."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    before = ivf_scan.LAUNCHES["ivf_list_scores_tiled"]
    out = ivf_scan.ivf_list_scores_tiled(*args)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled"] == before + 1
    assert torch.equal(out, _k7_first_version(*args))
    ref = ivf_scan.ivf_list_scores_tiled_reference(*args)
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    fin = torch.isfinite(ref)
    if fin.any():
        scale = ref[fin].abs().max().item()
        assert (out - ref)[fin].abs().max().item() <= STAGE1_RTOL * scale
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("b,p", [(1, 1001), (3, 250), (1100, 10)])
def test_k7_runs_of_slots(card, b, p):
    # A block walks a run of one query's slots, 160 a pass: one query's
    # 1001 slots over runs of 8 or more, three queries' 250, and 1100
    # queries of 10 (one run a query, the queries fill the card).
    args = [torch.from_numpy(x).to(card) for x in _k7_inputs(3, b, p, 70)]
    out = _k7_check(args)
    if b > 1:
        assert torch.isinf(out[1]).all()


@pytest.mark.cuda
def test_k7_edges_dead_slots_and_the_last_tile(card):
    # Window edges on and off the 16-column chunks, windows inside one
    # chunk, empty windows between live ones, and windows ending at the
    # last column of the last tile, at d=96 (the rows are read 8 ahead).
    from smqtk_indexing_tpu_torch.ops.ivf_scan import TILE_ROWS, W_TILED
    db3, s2t, t, ti, c0, lo, hi = _tiled_inputs(2, 4, 12, 71, d=96)
    edges = [(0, 640), (16, 32), (17, 18), (15, 17), (5, 5), (0, 1),
             (639, 640), (128, 129), (100, 356), (320, 320), (33, 639),
             (624, 640)]
    lo[:] = [e[0] for e in edges]
    hi[:] = [e[1] for e in edges]
    ti[:, ::3], c0[:, ::3] = 1, TILE_ROWS - W_TILED
    hi[3] = lo[3]
    out = _k7_check([torch.from_numpy(x).to(card)
                     for x in (db3, s2t, t, ti, c0, lo, hi)])
    assert torch.isinf(out[3]).all() and torch.isinf(out[:, 4]).all()


def _k6_inputs(n, d, b, p, dtype, seed):
    """K6's operands: random rows of ``dtype`` (int8 codes with a codec
    scale), a quarter of the slots dead inside each query's run, query 1
    (when there is one) without a live slot, window edges on and off the
    32-row tiles, and slot 0 the window of the database's last rows."""
    rng = np.random.default_rng(seed)
    if dtype == "int8":
        db = torch.from_numpy(rng.integers(-127, 128, size=(n, d))
                              .astype(np.int8))
        a = torch.from_numpy(rng.random(d).astype(np.float32) * 0.1)
    else:
        db = torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32)) \
            .to(getattr(torch, dtype))
        a = torch.ones(d)
    t = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32))
    starts = torch.from_numpy(
        rng.integers(0, (n - 512) // 32 + 1, size=(b, p)) * 32).int()
    lo = torch.from_numpy(rng.integers(0, 32, size=(b, p))).int()
    hi = torch.clamp(lo + torch.from_numpy(
        rng.integers(0, 481, size=(b, p))).int(), max=512)
    short = torch.from_numpy(rng.random((b, p)) < 0.1)
    lo[short] = torch.from_numpy(rng.integers(0, 500, size=int(short.sum()))
                                 ).int()
    hi[short] = lo[short] + torch.from_numpy(
        rng.integers(0, 13, size=int(short.sum()))).int()
    dead = torch.from_numpy(rng.random((b, p)) < 0.25)
    hi[dead] = lo[dead]
    starts[:, 0], lo[:, 0], hi[:, 0] = n - 512, 0, 512          # last rows
    if b > 1:
        hi[1] = lo[1]
    return db, t, a, starts, lo, hi


def _k6_check(args, card):
    """K6 on the card: one launch, +inf exactly outside the windows, and
    within 1e-5 of each score's sum of absolute terms of float64 and of
    its plain version. Returns the kernel's output."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    db, t, a, starts, lo, hi = args
    before = ivf_scan.LAUNCHES["ivf_list_scores"]
    out = ivf_scan.ivf_list_scores(*args)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["ivf_list_scores"] == before + 1
    ref = ivf_scan.ivf_list_scores_reference(*args)
    lane = torch.arange(ivf_scan.L_MAX, device=card)
    ok = (lane >= lo[..., None]) & (lane < hi[..., None])
    assert torch.equal(torch.isinf(out), ~ok)
    assert torch.equal(torch.isinf(ref), ~ok)
    for q0 in range(0, t.shape[0], 64):
        sl = slice(q0, q0 + 64)
        u = db[starts[sl].long()[..., None] + lane].double()
        au2 = ((u * a.double()) ** 2).sum(-1)
        prod = u * t[sl, None, None, :].double()
        exact = au2 - 2.0 * prod.sum(-1)
        mag = au2 + 2.0 * prod.abs().sum(-1)
        okq = ok[sl]
        tol = 1e-5 * mag[okq]
        assert ((out[sl].double() - exact)[okq].abs() <= tol).all()
        assert ((out[sl] - ref[sl]).double()[okq].abs() <= tol).all()
        del u, prod
    return out


K6_DTYPES = ["float32", "bfloat16", "int8"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K6_DTYPES)
@pytest.mark.parametrize("b,p", [(1, 1001), (3, 250), (1100, 10)])
def test_k6_runs_of_slots(card, b, p, dtype):
    # A block walks a run of one query's slots, 256 a pass: one query's
    # 1001 slots over runs of 8 or more, three queries' 250, and 1100
    # queries of 10 (one run a query, the queries fill the card).
    args = [x.to(card) for x in _k6_inputs(8192, 128, b, p, dtype, 72)]
    out = _k6_check(args, card)
    if b > 1:
        assert torch.isinf(out[1]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", K6_DTYPES)
@pytest.mark.parametrize("d", [128, 256])
def test_k6_edges_dead_slots_and_the_last_rows(card, d, dtype):
    # Window edges on and off the 32-row tiles and the 16-byte pieces,
    # one-row windows, empty windows between live ones, windows ending at
    # the database's last row; t a slice of a larger batch.
    db, t, a, starts, lo, hi = _k6_inputs(4096, d, 5, 13, dtype, 73 + d)
    edges = [(0, 512), (31, 33), (32, 64), (5, 5), (0, 1), (511, 512),
             (17, 18), (200, 200), (1, 480), (33, 63), (480, 512),
             (64, 96), (3, 500)]
    lo[:] = torch.tensor([e[0] for e in edges]).int()
    hi[:] = torch.tensor([e[1] for e in edges]).int()
    starts[:, ::4] = 4096 - 512
    hi[2] = lo[2]
    t_big = torch.cat([t, t]).to(card)
    out = _k6_check([db.to(card), t_big[1:6], a.to(card), starts.to(card),
                     lo.to(card), hi.to(card)], card)
    assert torch.isinf(out[2]).all() and torch.isinf(out[:, 3]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["int8", "bfloat16", "float32"])
def test_k3_is_bit_equal_to_plain_version(card, dtype):
    rng = np.random.default_rng(13)
    db3 = torch.from_numpy(rng.integers(-127, 128, size=(3, 128, 4096))
                           .astype(np.int8)).to(getattr(torch, dtype))
    sid = torch.from_numpy(rng.integers(0, 96, size=(7, 18)))
    sid[0, :2] = torch.tensor([0, 95])
    db3, sid = db3.to(card), sid.to(card)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.seg_gather_tiled(db3, sid)
    torch.cuda.synchronize()
    assert _launched(before) == {("seg_gather_tiled", "copy"): 1}
    assert torch.equal(out, fused_scan.seg_gather_tiled_reference(db3, sid))


@pytest.mark.cuda
@pytest.mark.parametrize("rerank", ["score", "gather"])
def test_tiled_query_ragged_blocks_match_cpu(card, monkeypatch, rerank):
    # A score budget small enough that 13 queries run in blocks of 4,
    # the last one ragged.
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    rng = np.random.default_rng(14)
    n_tiles, d, c = 2, 128, 16
    db3, s2t = _tiled_inputs(n_tiles, 1, 2, seed=14)[:2]
    s2t[:] = (db3.astype(np.float32) ** 2).sum(1, keepdims=True) * 1e-4
    a = np.full(d, 1e-2, np.float32)
    b_codec = np.zeros(d, np.float32)
    lens = np.bincount(np.sort(rng.integers(0, c, size=n_tiles * 4096)),
                       minlength=c)
    v_tile, v_col, v_len, v_orig, _ = ivf_scan.build_tiled_csr(
        lens[None, :], np.zeros(1, np.int64))
    table = ivf_scan.build_slot_table(v_orig, c)
    cents = rng.normal(size=(c, d)).astype(np.float32)
    q = rng.normal(size=(13, d)).astype(np.float32)
    per_query = 4 * 64 * ivf_scan.W_TILED + (18 * d * 128 if rerank
                                             == "gather" else 0)
    monkeypatch.setattr(ivf_scan, "SCORE_BYTES", 4 * per_query)
    outs = []
    for dev in (card, torch.device("cpu")):
        outs.append(ivf_scan.ivf_query_dma_tiled_table(
            *(torch.from_numpy(x).to(dev) for x in (db3, s2t, a, b_codec,
                                                    cents)),
            torch.from_numpy(table).long().to(dev),
            *(torch.from_numpy(x).to(dev) for x in (v_tile, v_col, v_len,
                                                    q)),
            k=10, nprobe_orig=3, rerank=rerank))
    (d_gpu, r_gpu), (d_cpu, r_cpu) = outs
    np.testing.assert_allclose(d_gpu.cpu().numpy(), d_cpu.numpy(),
                               rtol=DIST_RTOL, atol=1e-5)
    assert (r_gpu.cpu() == r_cpu).float().mean().item() >= 0.95


@pytest.mark.cuda
@pytest.mark.parametrize("storage,dtype,rerank", [
    ("code", "sq8", "score"), ("code", "sq8", "exact"),
    ("rows", "float32", "exact"), ("rows", "sq8", "exact")])
def test_ivf_index_on_card_matches_cpu(card, storage, dtype, rerank):
    # The card's index loads the CPU index's payload, so both query the
    # same centroids and codec; then both take the same update and removal.
    from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    rng = np.random.default_rng(15)
    centres = rng.random((32, 96), dtype=np.float32)
    x = (centres[rng.integers(0, 32, size=6000)]
         + rng.normal(size=(6000, 96)) / 12).astype(np.float32)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(6000)]
    kw = dict(n_lists=16, nprobe=4, random_seed=0, dtype=dtype,
              storage=storage, rerank=rerank)
    elem = DataMemoryElement()
    cpu = IvfNearestNeighborsIndex(index_element=elem, device="cpu", **kw)
    cpu.build_index(els[:5000])
    gpu = IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cuda",
        **kw)
    results = []
    for index in (gpu, cpu):
        index.update_index(els[5000:])
        index.remove_from_index(list(range(0, 6000, 7)))
        before = dict(ivf_scan.LAUNCHES)
        res = index.nn_many(els[1:40:2], 10)
        launched = {k for k in before if ivf_scan.LAUNCHES[k] > before[k]}
        assert bool(launched) == (index is gpu)
        results.append((np.array([[e.uuid() for e in r[0]] for r in res]),
                        np.array([r[1] for r in res])))
    (u_gpu, d_gpu), (u_cpu, d_cpu) = results
    if rerank == "score":
        # Score mode reports sqrt(s2 - 2<t, u> + ||q - b||^2): its f32
        # sums of terms up to ~50 cancel at small distances, so the two
        # devices' summation orders are compared on the squared distance,
        # within 1e-5 of that scale.
        assert_same_neighbours(u_gpu, d_gpu ** 2, u_cpu, d_cpu ** 2,
                               rtol=0.0, atol=1e-3)
    else:
        assert_same_neighbours(u_gpu, d_gpu, u_cpu, d_cpu, rtol=1e-4,
                               atol=1e-4)


# ---------------------------------------------------------------------------
# The codec slice: K8 (ivf_list_scores_tiled_pq), K1's int8 form
# ---------------------------------------------------------------------------

def _k8_inputs(m, n_tiles, b, p, seed):
    """Random uint8 code tiles (codes >= 128 included), stats with +inf
    rows, ADC tables, and probe windows: dead slots, budget padding, the
    last window of the last tile and a window at a tile's end."""
    from smqtk_indexing_tpu_torch.ops.ivf_scan import TILE_ROWS, W_TILED
    rng = np.random.default_rng(seed)
    db3c = rng.integers(0, 256, size=(n_tiles, m, TILE_ROWS)) \
        .astype(np.uint8)
    s2t = (rng.random((n_tiles, 1, TILE_ROWS)) * 30).astype(np.float32)
    s2t[rng.random(s2t.shape) < 0.05] = np.inf
    lut = rng.normal(size=(b, m * 256)).astype(np.float32)
    ti = rng.integers(0, n_tiles, size=(b, p)).astype(np.int32)
    c0 = (rng.integers(0, (TILE_ROWS - W_TILED) // 128 + 1, size=(b, p))
          * 128).astype(np.int32)
    lo = rng.integers(0, 128, size=(b, p)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, 513, size=(b, p)), W_TILED) \
        .astype(np.int32)
    ti[:, 0], c0[:, 0], hi[:, 0] = n_tiles - 1, TILE_ROWS - W_TILED, W_TILED
    ti[:, 2], c0[:, 2], hi[:, 2] = 0, TILE_ROWS - W_TILED, W_TILED
    hi[:, 1] = lo[:, 1]                                         # dead
    hi[:, p - 5:] = lo[:, p - 5:]                               # padding
    return db3c, s2t, lut, ti, c0, lo, hi


def _k8_check(args, card):
    """K8 on the card against its plain version and float64 (within 1e-5
    of each score's sum of absolute terms); +inf exactly where float64 has
    it. Returns the kernel's output."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    before = ivf_scan.LAUNCHES["ivf_list_scores_tiled_pq"]
    out = ivf_scan.ivf_list_scores_tiled_pq(*args)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled_pq"] == before + 1
    ref = ivf_scan.ivf_list_scores_tiled_pq_reference(*args)
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled_pq"] == before + 1
    assert torch.equal(torch.isinf(out), torch.isinf(ref))
    db3c, s2t, lut, ti, c0, lo, hi = args
    m = db3c.shape[1]
    lane = torch.arange(ivf_scan.W_TILED, device=card)
    cols = c0.long()[..., None] + lane
    codes = db3c[ti.long()[..., None, None],
                 torch.arange(m, device=card)[:, None], cols[:, :, None]]
    idx = (torch.arange(m, device=card)[:, None] * 256
           + (codes.long() & 0xFF))
    vals = torch.gather(lut.double()[:, None, :].expand(-1, ti.shape[1], -1),
                        2, idx.flatten(2)).view(idx.shape)
    s2 = s2t[ti.long()[..., None], 0, cols].double()
    ok = (lane >= lo[..., None]) & (lane < hi[..., None])
    exact = torch.where(ok, s2 - 2.0 * vals.sum(2), float("inf"))
    mag = s2.abs() + 2.0 * vals.abs().sum(2)
    assert torch.equal(torch.isinf(out), torch.isinf(exact))
    fin = torch.isfinite(exact)
    assert ((out.double() - exact)[fin].abs() <= 1e-5 * mag[fin]).all()
    assert ((out - ref)[fin].abs() <= 1e-5 * mag[fin]).all()
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 12, 16, 32, 64, 96])
def test_k8_matches_plain_version(card, m):
    # M=96: a 96 KB table, past the 64 subspaces a block stages at once, so
    # the kernel walks it in subspace chunks. 21 queries of 37 slots, each
    # cut into runs of 8 (the last of 5): odd counts for the two windows a
    # block scores at once.
    args = [torch.from_numpy(a).to(card)
            for a in _k8_inputs(m, 3, 21, 37, seed=16 + m)]
    out = _k8_check(args, card)
    assert torch.isinf(out[:, 1]).all() and torch.isinf(out[:, -5:]).all()


@pytest.mark.cuda
@pytest.mark.parametrize("b,p", [(1, 1001), (3, 250), (1100, 10)])
def test_k8_runs_of_slots(card, b, p):
    # A query's slots are cut into runs, a block each, while the queries
    # alone do not fill the card's resident blocks (8 an SM at M=16): one
    # query's 1001 slots into runs of 8 (the last of 1), three queries'
    # 250 into 32 runs each, and none cut where 1100 queries fill an H100.
    _k8_check([torch.from_numpy(x).to(card)
               for x in _k8_inputs(16, 4, b, p, seed=62 + b)], card)


@pytest.mark.cuda
def test_k8_one_block(card):
    # One query, six slots: live windows at the last tile's end (slot 0)
    # and tile 0's end (slot 2), the others dead.
    _k8_check([torch.from_numpy(x).to(card)
               for x in _k8_inputs(16, 2, 1, 6, seed=60)], card)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [16, 96])
def test_k8_dead_queries_inf_stats_and_tile_ends(card, m):
    # Query 0 has no live slot (it stages no table, writes +inf); query 1
    # scores windows that end at each tile's end, over rows whose stats
    # are all +inf in tile 1; codes 128..255 everywhere in tile 0.
    from smqtk_indexing_tpu_torch.ops.ivf_scan import TILE_ROWS, W_TILED
    db3c, s2t, lut, ti, c0, lo, hi = _k8_inputs(m, 3, 9, 24, seed=61)
    hi[0] = lo[0]
    ti[1], c0[1], lo[1], hi[1] = np.arange(24) % 3, TILE_ROWS - W_TILED, 0, \
        W_TILED
    db3c[0] |= 0x80
    s2t[1] = np.inf
    out = _k8_check([torch.from_numpy(x).to(card)
                     for x in (db3c, s2t, lut, ti, c0, lo, hi)], card)
    assert torch.isinf(out[0]).all()
    assert torch.isinf(out[1, 1::3]).all()
    assert torch.isfinite(out[1, 0::3]).any()


@pytest.mark.cuda
def test_k8_reads_int8_bit_patterns_as_unsigned(card):
    # The JAX layout stores uint8 codes as int8 bit patterns: the same
    # bytes must score the same.
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    db3c, *rest = [torch.from_numpy(a).to(card)
                   for a in _k8_inputs(16, 2, 5, 9, seed=30)]
    out_u = ivf_scan.ivf_list_scores_tiled_pq(db3c, *rest)
    out_i = ivf_scan.ivf_list_scores_tiled_pq(db3c.view(torch.int8), *rest)
    assert torch.equal(out_u, out_i)


@pytest.mark.cuda
def test_k1_int8_matches_plain_version(card):
    n, d, b = 8192, 128, 200
    rng = np.random.default_rng(17)
    codes = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    a = (rng.random(d) * 0.02).astype(np.float32)
    s2 = ((codes.astype(np.float64) * a) ** 2).sum(1).astype(np.float32)
    pen = np.where(rng.random(n) < 0.02, np.inf, 0.0).astype(np.float32)
    pen[128:256] = np.inf
    t = (rng.normal(size=(b, d)) * a).astype(np.float32)
    args = [torch.from_numpy(x).to(card) for x in (codes, s2, pen, t)]
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima", "wgmma"): 1}
    ref = fused_scan.segment_minima_reference(*args)
    assert torch.isinf(out[:, 1]).all()
    _assert_stage1(out, ref, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_flat_sq8_on_card_matches_cpu(card, metric):
    # 70,000 rows: capacity 131,072, past one streamed block and a
    # multiple of 4096, so the card's stage 1 is K1's int8 form.
    rng = np.random.default_rng(18)
    x = rng.random((70000, 48), dtype=np.float32)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(70000)]
    results = []
    for device in ("cuda", "cpu"):
        index = FlatNearestNeighborsIndex(dtype="sq8", metric=metric,
                                          device=device)
        index.build_index(els)
        index.remove_from_index(list(range(0, 70000, 9)))
        before = dict(fused_scan.LAUNCHES)
        res = index.nn_many(els[1:200:4], 10)
        launched = _launched(before)
        assert bool(launched) == (device == "cuda")
        assert set(launched) <= {("segment_minima", "wgmma")}
        results.append((np.array([[e.uuid() for e in r[0]] for r in res]),
                        np.array([r[1] for r in res])))
    (u_gpu, d_gpu), (u_cpu, d_cpu) = results
    assert_same_neighbours(u_gpu, d_gpu, u_cpu, d_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_ivf_pq_index_on_card_matches_cpu(card):
    # The 'OPQ16,IVF16,PQ16' residual code tier: the card's index loads the
    # CPU index's payload (centroids, codes, codebooks, rotation), then
    # both take the same update and removal. Exact mode runs K8 and K3.
    from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    rng = np.random.default_rng(19)
    centres = rng.random((32, 96), dtype=np.float32)
    x = (centres[rng.integers(0, 32, size=6000)]
         + rng.normal(size=(6000, 96)) / 12).astype(np.float32)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(6000)]
    kw = dict(n_lists=16, nprobe=4, random_seed=0, dtype="opq16",
              storage="code", pq_residual=True, rerank="exact")
    elem = DataMemoryElement()
    cpu = IvfNearestNeighborsIndex(index_element=elem, device="cpu", **kw)
    cpu.build_index(els[:5000])
    gpu = IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cuda",
        **kw)
    results = []
    for index in (gpu, cpu):
        index.update_index(els[5000:])
        index.remove_from_index(list(range(0, 6000, 7)))
        before = dict(ivf_scan.LAUNCHES)
        gathers = fused_scan.LAUNCHES["seg_gather_tiled", "copy"]
        res = index.nn_many(els[1:40:2], 10)
        on_card = index is gpu
        assert (ivf_scan.LAUNCHES["ivf_list_scores_tiled_pq"]
                > before["ivf_list_scores_tiled_pq"]) == on_card
        assert (fused_scan.LAUNCHES["seg_gather_tiled", "copy"]
                > gathers) == on_card
        results.append((np.array([[e.uuid() for e in r[0]] for r in res]),
                        np.array([r[1] for r in res])))
    np.testing.assert_array_equal(gpu._host, cpu._host)
    (u_gpu, d_gpu), (u_cpu, d_cpu) = results
    assert_same_neighbours(u_gpu, d_gpu, u_cpu, d_cpu, rtol=1e-4, atol=1e-4)


#: The wrappers of the tiled layout's stage 1: K2, K4, K5.
TILED_WRAPPERS = ("segment_minima_tiled", "segment_minima_blocked",
                  "segment_minima_tiled2")


def _tiled_case(card, dtype, n, tile_n, b, seed):
    """Stage-1 operands in the tiled layout on the card: (db3, db_sq,
    penalty, q), dead rows included."""
    db, sq, pen, q, _ = scan_inputs(n, 128, b, seed=seed)
    if dtype == "int8":
        rows = torch.from_numpy(np.clip(np.rint(db * 10), -127, 127)
                                .astype(np.int8))
        sq = (rows.float() ** 2).sum(1).numpy()
    else:
        rows = torch.from_numpy(db).to(getattr(torch, dtype))
    return (fused_scan.tiled_layout(rows, tile_n).to(card),
            torch.from_numpy(sq).to(card), torch.from_numpy(pen).to(card),
            torch.from_numpy(q).to(card))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [4096, 256])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_tiled_kernels_match_plain_versions(card, dtype, tile_n):
    # K2, K4 and K5 of csrc/segment_minima_tiled.cu at a ragged query tile
    # (200 = 128 + 72) over 6 tiles of 4096 (K5: 3 steps of 2 tiles, G = 64,
    # bw = 16) or 96 tiles of 256 (12 steps of 8 tiles, G = 16, bw = 16).
    n, b = 24576, 200
    db3, sq, pen, q = _tiled_case(card, dtype, n, tile_n, b, seed=21)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_tiled(db3, sq, pen, q)
    m1, m2 = fused_scan.segment_minima_tiled2(db3, sq, pen, q)
    blk = fused_scan.blocked_layout(
        db3.transpose(1, 2).reshape(n, 128))
    out_blk = fused_scan.segment_minima_blocked(
        blk, sq.view(-1, 128), pen.view(-1, 128), q)
    torch.cuda.synchronize()
    form = "wgmma" if dtype == "int8" else "ffma"
    assert _launched(before) == {(w, form): 1 for w in TILED_WRAPPERS}
    ref = fused_scan.segment_minima_tiled_reference(db3, sq, pen, q)
    n_steps, g, bw = fused_scan.step_shape(n // tile_n, tile_n)
    assert m1.shape == (n_steps, b, g) and m2.shape == (n_steps, b, g // bw)
    fin = torch.isfinite(ref)
    scale = ref[fin].abs().max().item()
    for got in (out, out_blk,
                m1.transpose(0, 1).reshape(b, -1)):
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        assert (got - ref)[fin].abs().max().item() <= STAGE1_RTOL * scale
    assert torch.isinf(out[:, 1]).all()
    # m2 is the minimum of m1 over each group, bit for bit.
    assert torch.equal(m2, m1.view(n_steps, b, g // bw, bw).amin(-1))


def _wgmma_tiled_inputs(card, b, n_tiles, tile_n, d, seed):
    """int8 codes in the tiled layout, their row stats, dead rows and a
    wholly dead segment (rows 128-255), rows of -128 and of 127, and a
    float query, on the card: (rows (N, d), db3, db_sq, penalty, q)."""
    db, sq, pen, q = _wgmma_inputs(b, n_tiles * tile_n, d, "int8", card,
                                   seed)
    return db, fused_scan.tiled_layout(db, tile_n), sq, pen, q


#: The tiled wgmma kernel's cases, (B, n_tiles, tile_n, d): queries past
#: one 64-query tile, at a ragged 128 and 256, and over several query
#: tiles (300); dims with a K-chunk tail (16, 48, 144); one segment a tile
#: (tile_n 128) and 32 (4096). K4 takes tile_n = 128, K5 tile_n = 4096
#: over 6 tiles (2 a step, bw 16) or 12 (4 a step, bw 128).
TILED_B = [1, 64, 127, 128, 200, 256, 300]
TILED_D = [16, 48, 128, 144]


@pytest.mark.cuda
def test_tiled_wgmma_one_block(card):
    # One block: 64 queries, one segment, d = 128 (K2's entry point).
    rows, db3, sq, pen, q = _wgmma_tiled_inputs(card, 64, 1, 128, 128,
                                                seed=40)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_tiled(db3, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_tiled", "wgmma"): 1}
    ref = fused_scan.segment_minima_tiled_reference(db3, sq, pen, q)
    _assert_stage1(out, ref, rows, sq, pen, q)


@pytest.mark.cuda
@pytest.mark.parametrize("d", TILED_D)
@pytest.mark.parametrize("tile_n", [128, 4096])
@pytest.mark.parametrize("b", TILED_B)
def test_k2_wgmma_matches_plain_and_f64(card, b, tile_n, d):
    n_tiles = 40 if tile_n == 128 else 3
    rows, db3, sq, pen, q = _wgmma_tiled_inputs(card, b, n_tiles, tile_n, d,
                                                seed=b + d + tile_n)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_tiled(db3, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_tiled", "wgmma"): 1}
    assert out.shape == (b, n_tiles * tile_n // 128)
    assert torch.isinf(out[:, 1]).all()
    ref = fused_scan.segment_minima_tiled_reference(db3, sq, pen, q)
    _assert_stage1(out, ref, rows, sq, pen, q)


@pytest.mark.cuda
@pytest.mark.parametrize("d", TILED_D)
@pytest.mark.parametrize("b", TILED_B)
def test_k4_wgmma_matches_plain_and_f64(card, b, d):
    # 200 segments: the last strip of 32 holds 8.
    rows, _, sq, pen, q = _wgmma_tiled_inputs(card, b, 200, 128, d,
                                              seed=2 * b + d)
    blk = fused_scan.blocked_layout(rows)
    args = (blk, sq.view(-1, 128), pen.view(-1, 128), q)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_blocked(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_blocked", "wgmma"): 1}
    assert torch.isinf(out[:, 1]).all()
    ref = fused_scan.segment_minima_blocked_reference(*args)
    _assert_stage1(out, ref, rows, sq, pen, q)


@pytest.mark.cuda
@pytest.mark.parametrize("n_tiles", [6, 12])
@pytest.mark.parametrize("d", TILED_D)
@pytest.mark.parametrize("b", TILED_B)
def test_k5_wgmma_matches_plain_and_f64(card, b, d, n_tiles):
    rows, db3, sq, pen, q = _wgmma_tiled_inputs(card, b, n_tiles, 4096, d,
                                                seed=3 * b + d + n_tiles)
    n_steps, g, bw = fused_scan.step_shape(n_tiles, 4096)
    assert bw == (16 if n_tiles == 6 else 128)
    pen[g * 128 * (n_steps - 1):g * 128 * (n_steps - 1) + 128 * bw] = \
        math.inf                       # a wholly dead group in the last step
    before = dict(fused_scan.LAUNCHES)
    m1, m2 = fused_scan.segment_minima_tiled2(db3, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_tiled2", "wgmma"): 1}
    assert m1.shape == (n_steps, b, g) and m2.shape == (n_steps, b, g // bw)
    ref1, ref2 = fused_scan.segment_minima_tiled2_reference(db3, sq, pen, q)
    _assert_stage1(m1.transpose(0, 1).reshape(b, -1),
                   ref1.transpose(0, 1).reshape(b, -1), rows, sq, pen, q)
    # m2 is the minimum of m1 over each group, bit for bit, +inf where the
    # plain version has it.
    assert torch.equal(m2, m1.view(n_steps, b, g // bw, bw).amin(-1))
    assert torch.equal(torch.isinf(m2), torch.isinf(ref2))
    assert torch.isinf(m2[-1, :, 0]).all()


@pytest.mark.cuda
def test_tiled_kernel_wrappers_reject_what_the_kernels_cannot_take(card):
    db3, sq, pen, q = _tiled_case(card, "int8", 8192, 4096, 8, seed=22)
    with pytest.raises(ValueError, match="contiguous"):
        fused_scan.segment_minima_tiled(db3.repeat(1, 2, 1)[:, ::2], sq,
                                        pen, q)
    with pytest.raises(ValueError, match="several devices"):
        fused_scan.segment_minima_tiled2(db3, sq.cpu(), pen, q)
    with pytest.raises(ValueError, match="multiple of 16"):
        fused_scan.segment_minima_tiled(db3[:, :120].contiguous(), sq, pen,
                                        q[:, :120].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "blocked"])
@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_sq8_topk_blocked_on_card_matches_cpu(card, metric, layout):
    from smqtk_indexing_tpu_torch.ops import sq8
    rng = np.random.default_rng(23)
    n, d, b, k = 32768, 128, 64, 16
    mat = rng.random((n, d), dtype=np.float32) * 10
    a, bb = sq8.sq8_train(mat)
    codes = torch.from_numpy(sq8.sq8_encode_np(mat, a, bb))
    q = torch.from_numpy(rng.random((b, d), dtype=np.float32) * 10)
    valid = torch.ones(n, dtype=torch.bool)
    valid[500:900] = False
    a, bb = torch.from_numpy(a), torch.from_numpy(bb)
    s2, _ = sq8.sq8_row_stats(codes, a, bb)
    lay = fused_scan.tiled_layout(codes) if layout == "tiled" \
        else fused_scan.blocked_layout(codes)
    cpu = (lay, a, bb, s2, valid, q)
    d_cpu, r_cpu = sq8.sq8_topk_blocked(*cpu, k=k, metric=metric)
    before = dict(fused_scan.LAUNCHES)
    d_gpu, r_gpu = sq8.sq8_topk_blocked(*(t.to(card) for t in cpu), k=k,
                                        metric=metric)
    torch.cuda.synchronize()
    assert _launched(before) == (
        {("segment_minima_tiled2", "wgmma"): 1, ("seg_gather_tiled", "copy"): 1}
        if layout == "tiled" else {("segment_minima_blocked", "wgmma"): 1})
    assert_same_neighbours(r_gpu.cpu().numpy(), d_gpu.cpu().numpy(),
                           r_cpu.numpy(), d_cpu.numpy(), rtol=DIST_RTOL,
                           atol=1e-5)


@pytest.mark.cuda
def test_capacity_module_on_card_at_a_mini_size(card):
    from smqtk_indexing_tpu_torch.examples import capacity_100m
    cap = capacity_100m.build(16, "cuda", seed=0)
    before = dict(fused_scan.LAUNCHES)
    for batch in (capacity_100m.B, capacity_100m.B_BIG):
        res = capacity_100m.check(cap, *capacity_100m.scan(cap, batch))
        assert res["recall_at_10"] == 1.0
        assert res["planted_to_random_margin"] > 1.0
    # K5 took the tensor-core form at both batches.
    assert _launched(before)[("segment_minima_tiled2", "wgmma")] == 2
    ms = capacity_100m.stages(cap, reps=1)
    assert set(ms) >= {"k2", "k5", "full"}
    assert all(v > 0 for v in ms.values())


# ---------------------------------------------------------------------------
# The int8 x int8 (i8dot) forms of K1, K2, K4 and K5, and the probes K10 and
# K9 (smqtk_indexing_tpu_torch/tools/)
# ---------------------------------------------------------------------------

def _i8i8_case(card, n, b, seed):
    """int8 codes (N, 128) with stats, dead rows, a wholly dead segment,
    and an int8 query with its stats divided by g, on the card."""
    from smqtk_indexing_tpu_torch.ops import sq8
    rng = np.random.default_rng(seed)
    codes = rng.integers(-127, 128, size=(n, 128)).astype(np.int8)
    a = (rng.random(128) * 0.02).astype(np.float32)
    s2 = ((codes.astype(np.float64) * a) ** 2).sum(1).astype(np.float32)
    pen = np.where(rng.random(n) < 0.02, np.inf, 0.0).astype(np.float32)
    pen[128:256] = np.inf
    t = (rng.normal(size=(b, 128)) * a).astype(np.float32)
    q, sq = sq8._i8dot_q(torch.from_numpy(t), torch.from_numpy(s2))
    return [x.to(card) for x in (torch.from_numpy(codes), sq,
                                 torch.from_numpy(pen), q)]


@pytest.mark.cuda
def test_k1_i8i8_is_bit_equal_to_plain_version(card):
    codes, sq, pen, q = _i8i8_case(card, 8192, 200, seed=31)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(codes, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima", "wgmma_s8"): 1}
    ref = fused_scan.segment_minima_reference(codes, sq, pen, q)
    assert torch.isinf(out[:, 1]).all()
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [4096, 256])
def test_tiled_i8i8_kernels_are_bit_equal_to_plain_versions(card, tile_n):
    # K2, K4, K5 with an int8 query at a ragged query tile (200 = 128 + 72)
    # over 6 tiles of 4096 or 96 tiles of 256.
    n, b = 24576, 200
    codes, sq, pen, q = _i8i8_case(card, n, b, seed=32)
    db3 = fused_scan.tiled_layout(codes, tile_n)
    blk = fused_scan.blocked_layout(codes)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_tiled(db3, sq, pen, q)
    m1, m2 = fused_scan.segment_minima_tiled2(db3, sq, pen, q)
    out_blk = fused_scan.segment_minima_blocked(blk, sq.view(-1, 128),
                                                pen.view(-1, 128), q)
    torch.cuda.synchronize()
    assert _launched(before) == {(w, "wgmma_s8"): 1 for w in TILED_WRAPPERS}
    ref = fused_scan.segment_minima_tiled_reference(db3, sq, pen, q)
    assert torch.isinf(ref[:, 1]).all()
    n_steps, g, bw = fused_scan.step_shape(n // tile_n, tile_n)
    for got in (out, out_blk, m1.transpose(0, 1).reshape(b, -1)):
        assert torch.equal(got, ref)
    assert torch.equal(m2, m1.view(n_steps, b, g // bw, bw).amin(-1))


def _s8_case(card, b, n, d, seed):
    """K1's int8 x int8 operands on the card: codes (N, d) with rows of
    -128 and of 127, dead rows and a wholly dead segment (rows 128-255),
    an int8 query from ``_i8dot_q`` with one row of 127 and one of -128,
    and the stats divided by its scale."""
    from smqtk_indexing_tpu_torch.ops import sq8
    rng = np.random.default_rng(seed)
    codes = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
    codes[0] = -128
    codes[1] = 127
    codes[n // 2] = -128
    a = (rng.random(d) * 0.02 + 0.001).astype(np.float32)
    s2 = ((codes.astype(np.float64) * a) ** 2).sum(1).astype(np.float32)
    pen = np.where(rng.random(n) < 0.03, np.inf, 0.0).astype(np.float32)
    pen[128:256] = np.inf
    t = (rng.normal(size=(b, d)) * a * 60).astype(np.float32)
    q, sq = sq8._i8dot_q(torch.from_numpy(t), torch.from_numpy(s2))
    q[0] = 127
    q[-1] = -128
    return [x.to(card) for x in (torch.from_numpy(codes), sq,
                                 torch.from_numpy(pen), q)]


#: The int8 x int8 forms on wgmma s8: B over one, two and four 64-query
#: tiles (1, 65, 200 ragged, 256), d with a K-chunk tail (32, 96) and one
#: whole chunk (128), all with the narrow fold (d <= 256), and over wider
#: d with I2F: the 256-query resident plan (512) and the 128-query one
#: (1024).
S8_B = [1, 65, 200, 256]
S8_D = [32, 96, 128, 512, 1024]


@pytest.mark.cuda
def test_k1_s8_one_block(card):
    # One block: 64 queries, one segment, d = 128.
    codes, sq, pen, q = _s8_case(card, 64, 128, 128, seed=50)
    pen[:] = 0.0
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(codes, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima", "wgmma_s8"): 1}
    assert torch.equal(out, fused_scan.segment_minima_reference(
        codes, sq, pen, q))


@pytest.mark.cuda
@pytest.mark.parametrize("d", S8_D)
@pytest.mark.parametrize("b", S8_B)
def test_k1_s8_is_bit_equal_to_plain_version(card, b, d):
    # 40 segments: a strip of 32 and a ragged one of 8.
    codes, sq, pen, q = _s8_case(card, b, 128 * 40, d, seed=b + d)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(codes, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima", "wgmma_s8"): 1}
    assert out.shape == (b, 40)
    assert torch.isinf(out[:, 1]).all()
    assert torch.equal(out, fused_scan.segment_minima_reference(
        codes, sq, pen, q))


@pytest.mark.cuda
def test_tiled_s8_one_block(card):
    # One block: 64 queries, one segment, d = 128 (K2's entry point).
    codes, sq, pen, q = _s8_case(card, 64, 128, 128, seed=51)
    db3 = fused_scan.tiled_layout(codes, 128)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_tiled(db3, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_tiled", "wgmma_s8"): 1}
    assert torch.equal(out, fused_scan.segment_minima_tiled_reference(
        db3, sq, pen, q))


@pytest.mark.cuda
@pytest.mark.parametrize("tile_n", [128, 4096])
@pytest.mark.parametrize("d", S8_D)
@pytest.mark.parametrize("b", S8_B)
def test_k2_s8_is_bit_equal_to_plain_version(card, b, d, tile_n):
    # 40 one-segment tiles (a ragged last strip of 8) or 3 tiles of 32.
    n_tiles = 40 if tile_n == 128 else 3
    codes, sq, pen, q = _s8_case(card, b, n_tiles * tile_n, d,
                                 seed=2 * b + d + tile_n)
    db3 = fused_scan.tiled_layout(codes, tile_n)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_tiled(db3, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_tiled", "wgmma_s8"): 1}
    assert torch.isinf(out[:, 1]).all()
    assert torch.equal(out, fused_scan.segment_minima_tiled_reference(
        db3, sq, pen, q))


@pytest.mark.cuda
@pytest.mark.parametrize("d", S8_D)
@pytest.mark.parametrize("b", S8_B)
def test_k4_s8_is_bit_equal_to_plain_version(card, b, d):
    # 200 segments: the last strip of 32 holds 8.
    codes, sq, pen, q = _s8_case(card, b, 200 * 128, d, seed=3 * b + d)
    args = (fused_scan.blocked_layout(codes), sq.view(-1, 128),
            pen.view(-1, 128), q)
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima_blocked(*args)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_blocked", "wgmma_s8"): 1}
    assert torch.isinf(out[:, 1]).all()
    assert torch.equal(out, fused_scan.segment_minima_blocked_reference(
        *args))


@pytest.mark.cuda
@pytest.mark.parametrize("d", S8_D)
@pytest.mark.parametrize("b", S8_B)
def test_k5_s8_is_bit_equal_to_plain_version(card, b, d):
    # 6 tiles of 4096: 3 steps of 2 tiles, G = 64, bw = 16, a wholly dead
    # group in the last step.
    codes, sq, pen, q = _s8_case(card, b, 6 * 4096, d, seed=5 * b + d)
    db3 = fused_scan.tiled_layout(codes)
    n_steps, g, bw = fused_scan.step_shape(6, 4096)
    pen[g * 128 * (n_steps - 1):g * 128 * (n_steps - 1) + 128 * bw] = \
        math.inf
    before = dict(fused_scan.LAUNCHES)
    m1, m2 = fused_scan.segment_minima_tiled2(db3, sq, pen, q)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima_tiled2", "wgmma_s8"): 1}
    ref1, ref2 = fused_scan.segment_minima_tiled2_reference(db3, sq, pen, q)
    assert torch.equal(m1, ref1) and torch.equal(m2, ref2)
    assert torch.isinf(m2[-1, :, 0]).all()


@pytest.mark.cuda
def test_s8_streamed_plans_are_bit_equal_to_plain_versions(card):
    # Widths whose query tile streams through the ring: K1 above d = 1280,
    # the tiled kernel above 1536. Codes and queries in [-64, 64] keep
    # every sum under 2^24 (exact in f32) at these widths.
    for d in (1408, 1600):
        rng = np.random.default_rng(d)
        codes = torch.from_numpy(rng.integers(-64, 65, size=(4096, d))
                                 .astype(np.int8)).to(card)
        q = torch.from_numpy(rng.integers(-64, 65, size=(65, d))
                             .astype(np.int8)).to(card)
        sq = torch.from_numpy(rng.random(4096).astype(np.float32)
                              * 1e5).to(card)
        pen = torch.zeros(4096, device=card)
        pen[128:256] = math.inf
        before = dict(fused_scan.LAUNCHES)
        out = fused_scan.segment_minima(codes, sq, pen, q)
        db3 = fused_scan.tiled_layout(codes, 1024)
        m1, m2 = fused_scan.segment_minima_tiled2(db3, sq, pen, q)
        torch.cuda.synchronize()
        assert _launched(before) == {("segment_minima", "wgmma_s8"): 1,
                                     ("segment_minima_tiled2", "wgmma_s8"): 1}
        assert torch.equal(out, fused_scan.segment_minima_reference(
            codes, sq, pen, q))
        ref1, ref2 = fused_scan.segment_minima_tiled2_reference(db3, sq, pen,
                                                                q)
        assert torch.equal(m1, ref1) and torch.equal(m2, ref2)


@pytest.mark.cuda
def test_i8i8_wrappers_and_refused_launches_raise(card):
    from smqtk_indexing_tpu_torch.ops import _kernels
    codes, sq, pen, q = _i8i8_case(card, 4096, 8, seed=33)
    with pytest.raises(ValueError, match="int8 queries"):
        fused_scan.segment_minima(codes.float(), sq, pen, q)
    db3 = fused_scan.tiled_layout(codes[:, :112].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_scan.segment_minima_tiled(db3, sq, pen,
                                        q[:, :112].contiguous())
    with pytest.raises(ValueError, match="multiple of 32"):
        fused_scan.segment_minima(codes[:, :112].contiguous(), sq, pen,
                                  q[:, :112].contiguous())
    # A launch the kernel refuses (tile_n not a multiple of 128) returns
    # its error, and the wrapper's check raises.
    out = torch.empty((8, 32), device=card)
    lib = _kernels.library()
    err = lib.segment_minima_tiled_i8i8(
        q.data_ptr(), codes.data_ptr(), sq.data_ptr(), pen.data_ptr(),
        out.data_ptr(), 8, 1, 128, 4000, 1.0, card.index or 0,
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernels.check(err, "segment_minima_tiled_i8i8")
    err = lib.stage1_variant_i8(
        q.float().data_ptr(), codes.data_ptr(), sq.data_ptr(),
        pen.data_ptr(), out.data_ptr(), 8, 1, 128, 4096, 32, 9,
        card.index or 0, torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="CUDA error"):
        _kernels.check(err, "stage1_variant_i8")


@pytest.mark.cuda
def test_k10_arms_match_plain_version(card):
    from smqtk_indexing_tpu_torch.tools import probe_int8_mxu as k10
    inputs = k10.make_inputs("cuda", n=65536, b=130, seed=3)
    args = (inputs["db_t"], inputs["sq"], inputs["pen"])
    before = dict(k10.LAUNCHES)
    out = k10.scan_minima(*args, inputs["q_i8"], inputs["g"], int8dot=True)
    ref = k10.scan_minima_reference(*args, inputs["q_i8"], inputs["g"],
                                    int8dot=True)
    assert torch.equal(out, ref)
    out = k10.scan_minima(*args, inputs["q_bf"], inputs["g"], int8dot=False)
    ref = k10.scan_minima_reference(*args, inputs["q_bf"], inputs["g"],
                                    int8dot=False)
    torch.cuda.synchronize()
    assert k10.LAUNCHES == {"int8dot": before["int8dot"] + 1,
                            "bf16": before["bf16"] + 1}
    scale = ref.abs().max().item()
    assert (out - ref).abs().max().item() <= STAGE1_RTOL * scale
    res = k10.run(inputs, reps=1, depth=2)
    assert 0.0 <= res["overlap_min"] <= res["overlap_mean"] <= 1.0
    assert res["int8dot_ms"] > 0 and res["bf16_ms"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("query", ["int8", "bf16"])
def test_k9_variants_one_block(card, query):
    # One block a variant: 64 queries, one tile of 1024 rows (8 segments,
    # so nomin fills 8 slots), d = 128.
    from smqtk_indexing_tpu_torch.tools import stage1_analysis as k9
    codes, sq, pen, q = _i8i8_case(card, 1024, 64, seed=52)
    if query == "bf16":
        q = q.float() * 0.01
    db3 = fused_scan.tiled_layout(codes, 1024)
    for variant in ("full", "folded", "nomin", "nodot", "bf16min"):
        out = k9.run_variant(db3, sq, pen, q, variant=variant, t_step=1)
        torch.cuda.synchronize()
        ref = k9.run_variant_reference(db3, sq, pen, q, variant=variant,
                                       t_step=1)
        assert out.shape == ref.shape == (1, 64, 8)
        assert torch.equal(torch.isinf(out), torch.isinf(ref)), variant
        fin = torch.isfinite(ref)
        tol = 0.0 if query == "int8" or variant == "nodot" else \
            STAGE1_RTOL * ref[fin].abs().max().item() + (
                k9.bf16_ulp(ref[fin]) if variant == "bf16min" else 0.0)
        assert ((out - ref)[fin].abs() <= tol).all(), variant


@pytest.mark.cuda
@pytest.mark.parametrize("t_step", [2, 4, 8])
@pytest.mark.parametrize("query", ["int8", "bf16"])
def test_k9_variants_match_plain_versions(card, query, t_step):
    # Every variant on its instantiation of the tiled tensor-core kernel
    # (wgmma bf16 or s8), over 8 tiles: t_step tiles a step. 120 queries:
    # the variants but full are built for the probe's plan (at most 128
    # queries resident), here with its second 64-row tile part empty.
    from smqtk_indexing_tpu_torch.tools import stage1_analysis as k9
    codes, sq, pen, q = _i8i8_case(card, 8 * 4096, 120, seed=34)
    if query == "bf16":
        q = torch.from_numpy(np.random.default_rng(35).normal(
            size=(120, 128)).astype(np.float32)).to(card)
    db3 = fused_scan.tiled_layout(codes)
    form = "wgmma_s8" if query == "int8" else "wgmma"
    k2 = fused_scan.segment_minima_tiled(db3, sq, pen, q)
    for variant in k9.VARIANTS:
        before = dict(k9.LAUNCHES)
        out = k9.run_variant(db3, sq, pen, q, variant=variant,
                             t_step=t_step)
        torch.cuda.synchronize()
        ran = k9.SAME_AS.get(variant, variant)
        assert k9.LAUNCHES[ran] == before[ran] + 1
        assert fused_scan._ENTRY_FORM[
            "stage1_variant_" + ("i8i8" if query == "int8" else "i8")] \
            == form
        ref = k9.run_variant_reference(db3, sq, pen, q, variant=variant,
                                       t_step=t_step)
        assert out.shape == ref.shape == (8 // t_step, 120, 32 * t_step)
        if ran == "full":
            # Production's K2, bit for bit: the same instantiation.
            assert torch.equal(out.transpose(0, 1).reshape(120, -1), k2)
            full = out
        if variant == "bf16min":
            # The same products, each score rounded: full's rounded.
            assert torch.equal(out, full.to(torch.bfloat16).float())
        assert torch.equal(torch.isinf(out), torch.isinf(ref)), variant
        if query == "int8" or variant == "nodot":
            assert torch.equal(out, ref), variant
            continue
        fin = torch.isfinite(ref)
        err = (out - ref)[fin].abs()
        tol = STAGE1_RTOL * ref[fin].abs().max().item()
        if variant == "bf16min":
            # f32 sums in another order may round to the neighbouring bf16.
            tol = tol + k9.bf16_ulp(ref[fin])
        assert (err <= tol).all(), variant
    # Past the probe's plan: full (K2's own) runs, the others refuse.
    q2 = torch.cat([q, q])
    out = k9.run_variant(db3, sq, pen, q2, variant="full", t_step=t_step)
    assert torch.equal(out.transpose(0, 1).reshape(240, -1),
                       fused_scan.segment_minima_tiled(db3, sq, pen, q2))
    with pytest.raises(ValueError, match="at most 128"):
        k9.run_variant(db3, sq, pen, q2, variant="nodot", t_step=t_step)
    with pytest.raises(ValueError, match="CUDA"):
        k9.sweep(db3.cpu(), sq.cpu(), pen.cpu(), q.cpu())
    rows = k9.sweep(db3, sq, pen, q, reps=1, variants=("full", "staged"),
                    t_steps=(2,))
    assert rows[1]["same_as"] == "full" and rows[0]["value"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["tiled", "blocked"])
def test_sq8_topk_blocked_i8dot_on_card_matches_cpu(card, layout):
    from smqtk_indexing_tpu_torch.ops import sq8
    rng = np.random.default_rng(36)
    n, d, b, k = 32768, 128, 64, 16
    mat = rng.random((n, d), dtype=np.float32) * 10
    a, bb = sq8.sq8_train(mat)
    codes = torch.from_numpy(sq8.sq8_encode_np(mat, a, bb))
    q = torch.from_numpy(rng.random((b, d), dtype=np.float32) * 10)
    valid = torch.ones(n, dtype=torch.bool)
    valid[500:900] = False
    a, bb = torch.from_numpy(a), torch.from_numpy(bb)
    s2, _ = sq8.sq8_row_stats(codes, a, bb)
    lay = fused_scan.tiled_layout(codes) if layout == "tiled" \
        else fused_scan.blocked_layout(codes)
    cpu = (lay, a, bb, s2, valid, q)
    d_cpu, r_cpu = sq8.sq8_topk_blocked(*cpu, k=k, i8dot=True)
    name = "segment_minima_tiled2" if layout == "tiled" \
        else "segment_minima_blocked"
    before = fused_scan.LAUNCHES[name, "wgmma_s8"]
    d_gpu, r_gpu = sq8.sq8_topk_blocked(*(t.to(card) for t in cpu), k=k,
                                        i8dot=True)
    torch.cuda.synchronize()
    assert fused_scan.LAUNCHES[name, "wgmma_s8"] == before + 1
    assert_same_neighbours(r_gpu.cpu().numpy(), d_gpu.cpu().numpy(),
                           r_cpu.numpy(), d_cpu.numpy(), rtol=DIST_RTOL,
                           atol=1e-5)


@pytest.mark.cuda
def test_flat_sq8_i8dot_flag_on_card_matches_cpu(card, monkeypatch):
    rng = np.random.default_rng(37)
    x = rng.random((70000, 48), dtype=np.float32)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(70000)]
    monkeypatch.setenv("SMQTK_TPU_SQ8_I8DOT", "1")
    results = []
    for device in ("cuda", "cpu"):
        index = FlatNearestNeighborsIndex(dtype="sq8", device=device)
        index.build_index(els)
        index.remove_from_index(list(range(0, 70000, 9)))
        before = fused_scan.LAUNCHES["segment_minima", "wgmma_s8"]
        res = index.nn_many(els[1:200:4], 10)
        assert (fused_scan.LAUNCHES["segment_minima", "wgmma_s8"] > before) \
            == (device == "cuda")
        results.append((np.array([[e.uuid() for e in r[0]] for r in res]),
                        np.array([r[1] for r in res])))
    (u_gpu, d_gpu), (u_cpu, d_cpu) = results
    assert_same_neighbours(u_gpu, d_gpu, u_cpu, d_cpu, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_capacity_module_i8dot_on_card_at_a_mini_size(card):
    from smqtk_indexing_tpu_torch.examples import capacity_100m
    cap = capacity_100m.build(16, "cuda", seed=0)
    before = dict(fused_scan.LAUNCHES)
    for batch in (capacity_100m.B, capacity_100m.B_BIG):
        res = capacity_100m.check(cap, *capacity_100m.scan(cap, batch,
                                                           i8dot=True))
        assert res["recall_at_10"] == 1.0
        assert res["planted_to_random_margin"] > 1.0
    assert _launched(before)[("segment_minima_tiled2", "wgmma_s8")] == 2
    ms = capacity_100m.stages(cap, reps=1, i8dot=True)
    assert _launched(before)[("segment_minima_tiled", "wgmma_s8")] > 0
    assert all(v > 0 for v in ms.values())


# ---------------------------------------------------------------------------
# The JAX kernel opt-outs: the same route as the JAX package, on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "sq8"])
def test_flat_store_honours_no_fused(card, monkeypatch, dtype):
    # 70,000 rows: the sq8 store's capacity (131,072) takes K1's int8
    # form. Under SMQTK_TPU_NO_FUSED no K1 form launches and the results
    # are the CPU store's under the same switch.
    from smqtk_indexing_tpu_torch.ops.store import VectorStore
    rng = np.random.default_rng(70)
    x = rng.random((70000, 48), dtype=np.float32)
    q = rng.random((9, 48), dtype=np.float32)
    stores = {dev: VectorStore(dtype, device=dev) for dev in (card, "cpu")}
    for s in stores.values():
        s.build(x, list(range(len(x))))
        s.remove(list(range(0, len(x), 17)))
    before = dict(fused_scan.LAUNCHES)
    stores[card].knn(q, 10, "euclidean")
    # K1, and the f32 store's stage-2 kernel (the sq8 store re-ranks in
    # ops/sq8).
    assert sum(_launched(before).values()) == (2 if dtype == "float32"
                                               else 1)
    monkeypatch.setenv("SMQTK_TPU_NO_FUSED", "1")
    for metric in ("euclidean", "inner_product"):
        before = dict(fused_scan.LAUNCHES)
        d_g, u_g, _ = stores[card].knn(q, 10, metric)
        assert _launched(before) == {}
        d_c, u_c, _ = stores["cpu"].knn(q, 10, metric)
        assert_same_neighbours(np.array(u_g), d_g, np.array(u_c), d_c,
                               DIST_RTOL, 1e-5)
    report = FlatNearestNeighborsIndex.usability_report()
    assert report["disabled_flags"] == ["SMQTK_TPU_NO_FUSED"]
    assert report["degraded"] and report["kernel_tier"] == "cuda"


def _ivf_switch_case(card, monkeypatch, switch, dtype, rerank):
    """A rows-tier index on the card and on the CPU, the card's loading
    the CPU's payload, with ``switch`` set before either lays out; their
    launches of ivf_scan's kernels (card) over one query batch, and their
    results."""
    from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    monkeypatch.setenv(switch, "1")
    rng = np.random.default_rng(71)
    centres = rng.random((32, 96), dtype=np.float32)
    x = (centres[rng.integers(0, 32, size=6000)]
         + rng.normal(size=(6000, 96)) / 12).astype(np.float32)
    els = [DescriptorMemoryElement(i, x[i]) for i in range(6000)]
    kw = dict(n_lists=16, nprobe=4, random_seed=0, dtype=dtype,
              storage="rows", rerank=rerank, pq_residual=dtype == "pq16")
    elem = DataMemoryElement()
    cpu = IvfNearestNeighborsIndex(index_element=elem, device="cpu", **kw)
    cpu.build_index(els)
    gpu = IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cuda",
        **kw)
    before = dict(ivf_scan.LAUNCHES)
    res = gpu.nn_many(els[1:80:2], 10)
    launched = {k: n - before[k] for k, n in ivf_scan.LAUNCHES.items()
                if n != before[k]}
    ref = cpu.nn_many(els[1:80:2], 10)
    report = IvfNearestNeighborsIndex.usability_report()
    # The JAX index lists its two opt-outs; SMQTK_TPU_ROWS_TILED forces a
    # kernel route and is not one.
    listed = switch != "SMQTK_TPU_ROWS_TILED"
    assert (switch in report["disabled_flags"]) == listed
    assert report["degraded"] == listed
    return gpu, launched, [
        (np.array([[e.uuid() for e in r[0]] for r in rr]),
         np.array([r[1] for r in rr])) for rr in (res, ref)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rerank", [("float32", "exact"),
                                          ("sq8", "score"),
                                          ("pq16", "exact")])
def test_ivf_rows_tier_honours_no_dma_ivf(card, monkeypatch, dtype, rerank):
    # No K6, and no tiled routing (K7 / K8): the plain list gathers.
    gpu, launched, ((u_g, d_g), (u_c, d_c)) = _ivf_switch_case(
        card, monkeypatch, "SMQTK_TPU_NO_DMA_IVF", dtype, rerank)
    assert gpu._dev3 is None and launched == {}
    assert u_g.shape == (40, 10) and np.isfinite(d_g).all()
    if dtype != "pq16":  # a PQ codec trained on each device differs
        assert_same_neighbours(u_g, d_g, u_c, d_c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ivf_rows_tier_honours_no_rows_tiled(card, monkeypatch):
    # sq8 score mode lays out row-major and takes K6, not K7.
    gpu, launched, ((u_g, d_g), (u_c, d_c)) = _ivf_switch_case(
        card, monkeypatch, "SMQTK_TPU_NO_ROWS_TILED", "sq8", "score")
    assert gpu._dev3 is None and launched == {"ivf_list_scores": 1}
    assert_same_neighbours(u_g, d_g, u_c, d_c, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ivf_rows_tier_honours_rows_tiled(card, monkeypatch):
    # sq8 exact mode, which the rows tier lays out row-major, is forced
    # onto the tiled engine: K7, then K3 for the exact re-rank.
    gpu, launched, ((u_g, d_g), (u_c, d_c)) = _ivf_switch_case(
        card, monkeypatch, "SMQTK_TPU_ROWS_TILED", "sq8", "exact")
    assert gpu._dev3 is not None
    assert launched == {"ivf_list_scores_tiled": 1}
    assert_same_neighbours(u_g, d_g, u_c, d_c, rtol=1e-4, atol=1e-4)


# -- hashing and LSH: the ±1 route through K1's bf16 form -------------------

def _bool_codes(n, width, seed):
    return np.random.default_rng(seed).integers(
        0, 2, size=(n, width)).astype(bool)


def _popcount_rows(a, b):
    """Hamming distances of packed uint32 rows ``a`` (B, W) to ``b`` (N,
    W), by a byte table: (B, N) int64."""
    lut = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return lut[x].sum(-1)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [128, 256])
def test_pm1_route_matches_xor_route_and_numpy(card, monkeypatch, width):
    from smqtk_indexing_tpu_torch.ops.hamming import CodeStore
    from smqtk_indexing_tpu_torch.utils.bits import pack_bit_vectors_u32
    mat = _bool_codes(20000, width, seed=width)
    q = np.vstack([mat[:4], _bool_codes(28, width, seed=width + 1)])
    store = CodeStore(device="cuda")
    store.build(mat)
    before = dict(fused_scan.LAUNCHES)
    d, codes = store.knn(q, 16)
    assert _launched(before) == {("segment_minima", "wgmma"): 1,
                                 ("rerank_segments", "bf16"): 1}
    assert store._dev_pm1.shape == (32768, width)
    monkeypatch.setenv("SMQTK_TPU_NO_MXU_HAMMING", "1")
    before = dict(fused_scan.LAUNCHES)
    d_xor, codes_xor = store.knn(q, 16)
    assert _launched(before) == {}
    full = _popcount_rows(pack_bit_vectors_u32(q), store._host)
    oracle = np.sort(full, axis=1)[:, :16]
    assert np.array_equal(d, oracle) and np.array_equal(d_xor, oracle)
    assert (d[:4, 0] == 0).all()
    assert np.array_equal((q[:, None, :] ^ codes).sum(-1), d)
    for i in range(len(q)):
        below = d[i] < d[i, -1]
        assert {c.tobytes() for c in codes[i][below]} == \
            {c.tobytes() for c in codes_xor[i][below]}


@pytest.mark.cuda
def test_xor_route_on_card_matches_cpu(card):
    from smqtk_indexing_tpu_torch.ops import hamming
    from smqtk_indexing_tpu_torch.utils.bits import pack_bit_vectors_u32
    db = pack_bit_vectors_u32(_bool_codes(70000, 64, seed=1))
    q = pack_bit_vectors_u32(_bool_codes(40, 64, seed=2))
    valid = np.random.default_rng(3).random(70000) > 0.05
    out = []
    for dev in ("cuda", "cpu"):
        dd, rr = hamming.hamming_topk(
            hamming.words_to_tensor(db, dev),
            torch.from_numpy(valid).to(dev), hamming.words_to_tensor(q, dev),
            k=24, chunk=16384)
        out.append((dd.cpu().numpy(), rr.cpu().numpy()))
    assert np.array_equal(out[0][0], out[1][0])
    assert np.array_equal(out[0][1], out[1][1])


def _lsh_pair(engine_env, monkeypatch):
    from smqtk_indexing_tpu_torch.data import DataMemoryElement
    from smqtk_indexing_tpu_torch.models.lsh_functor.itq import ItqFunctor
    from smqtk_indexing_tpu_torch.models.nn_index.lsh import (
        LSHNearestNeighborIndex,
    )
    for var, val in engine_env.items():
        monkeypatch.setenv(var, val)
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6000, 32)).astype(np.float32)
    q = rng.normal(size=(40, 32)).astype(np.float32)
    mv, rot = DataMemoryElement(), DataMemoryElement()
    cpu_f = ItqFunctor(mv, rot, bit_length=16, random_seed=0, device="cpu")
    cpu_f.fit([DescriptorMemoryElement(i, v) for i, v in enumerate(x[:3000])])
    gpu_f = ItqFunctor(DataMemoryElement(mv.get_bytes()),
                       DataMemoryElement(rot.get_bytes()), bit_length=16,
                       device="cuda")
    out = []
    for dev, f in (("cuda", gpu_f), ("cpu", cpu_f)):
        index = LSHNearestNeighborIndex(lsh_functor=f, device=dev,
                                        distance_method="euclidean")
        index.build_index([DescriptorMemoryElement(i, v)
                           for i, v in enumerate(x)])
        before = dict(fused_scan.LAUNCHES)
        res = index.nn_many([DescriptorMemoryElement(("q", i), v)
                             for i, v in enumerate(q)], 10)
        out.append(([[e.uuid() for e in r[0]] for r in res],
                    [list(r[1]) for r in res], _launched(before), index))
    return x, q, cpu_f.get_hash_batch(x), cpu_f.get_hash_batch(q), out


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["xor", "two_call"])
def test_lsh_serve_on_card_matches_cpu(card, monkeypatch, path):
    env = {"SMQTK_TPU_NO_LSH_FUSED": "1"} if path == "two_call" else {}
    _, _, _, _, ((u, d, launched, gpu), (u_c, d_c, _, _)) = _lsh_pair(
        env, monkeypatch)
    assert launched == {}          # 6000 rows: XOR route, host scan
    assert (gpu._fused is None) == (path == "two_call")
    for i in range(len(u_c)):
        assert_same_neighbours([u[i]], [d[i]], [u_c[i]], [d_c[i]],
                               rtol=DIST_RTOL, atol=1e-5)


@pytest.mark.cuda
def test_lsh_fused_mxu_engine_on_card(card, monkeypatch):
    from tests.test_torch_helpers import assert_valid_lsh_answer
    x, q, row_codes, q_codes, ((u, d, launched, gpu), (u_c, d_c, _, _)) = \
        _lsh_pair({"SMQTK_TPU_LSH_FUSED_MXU": "1"}, monkeypatch)
    assert gpu._fused["pm1"] is not None
    assert launched == {("segment_minima", "wgmma"): 1,
                        ("rerank_segments", "bf16"): 1}
    uniq = np.unique(row_codes, axis=0)
    untied = 0
    for i in range(len(q)):
        assert_valid_lsh_answer(u[i], d[i], q[i], q_codes[i], row_codes, x,
                                10, rtol=DIST_RTOL, atol=1e-5)
        s = np.sort((uniq ^ q_codes[i]).sum(-1))
        if s[9] < s[10]:
            untied += 1
            assert_same_neighbours([u[i]], [d[i]], [u_c[i]], [d_c[i]],
                                   rtol=DIST_RTOL, atol=1e-5)
    assert untied > 0


# ---------------------------------------------------------------------------
# MRPT: K6's int8 form on the leaf-ordered mirror
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_k6_int8_d1024_past_4gib_operand(card):
    # The mirror's shape: int8 rows of 1,024 bytes, an operand past 2^32
    # bytes (row 2^22 starts at byte 2^32), windows near its end and across
    # that row. Codes in [-64, 64), a = 1 and integer t keep every sum an
    # integer below 2^24, so the kernel equals its plain version bit for
    # bit.
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    d, n = 1024, (1 << 22) + (1 << 16)
    assert n * d > 1 << 32
    gen = torch.Generator(device=card).manual_seed(7)
    db = torch.randint(-64, 64, (n, d), dtype=torch.int8, device=card,
                       generator=gen)
    rng = np.random.default_rng(8)
    b, p = 3, 16
    t = torch.from_numpy(rng.integers(-8, 9, size=(b, d))
                         .astype(np.float32)).to(card)
    a = torch.ones(d, device=card)
    starts = torch.from_numpy(
        (n - 512 - 32 * rng.integers(0, 64, size=(b, p))).astype(np.int32))
    starts[:, 1] = (1 << 22) - 256                   # across byte 2^32
    starts[:, 2] = n - 512                           # the last rows
    lo = torch.from_numpy(rng.integers(0, 32, size=(b, p))).int()
    hi = torch.clamp(lo + torch.from_numpy(
        rng.integers(1, 481, size=(b, p))).int(), max=512)
    lo[:, 2], hi[:, 2] = 0, 512
    hi[:, 3] = lo[:, 3]                              # dead
    args = [db, t, a] + [x.to(card) for x in (starts, lo, hi)]
    before = ivf_scan.LAUNCHES["ivf_list_scores"]
    out = ivf_scan.ivf_list_scores(*args)
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["ivf_list_scores"] == before + 1
    ref = ivf_scan.ivf_list_scores_reference(*args)
    assert torch.equal(out, ref)
    assert torch.isinf(out[:, 3]).all() and torch.isfinite(out[:, 2]).all()
    # One window against float64 straight from the codes past byte 2^32.
    u = db[n - 512:].double()
    exact = (u * u).sum(1) - 2.0 * (u @ t[0].double())
    assert torch.equal(out[0, 2].double(), exact)
    del db


def _mrpt_state(n=3000, d=48, t_count=4, depth=3):
    """A clustered MRPT state from the port's own CPU build (numpy
    arrays): rows padded to 128, bases, trees, the SQ8 mirror."""
    from smqtk_indexing_tpu_torch.ops import mrpt, sq8
    rng = np.random.default_rng(21)
    centers = rng.normal(size=(24, d)).astype(np.float32) * 4
    x = np.zeros((n, 128), np.float32)
    x[:, :d] = centers[rng.integers(0, 24, n)] \
        + rng.normal(size=(n, d)).astype(np.float32) * 0.3
    bases = np.zeros((t_count, 128, depth), np.float32)
    bases[:, :d] = rng.standard_normal((t_count, d, depth))
    projs = mrpt.project_all(torch.from_numpy(x),
                             torch.from_numpy(bases)).numpy()
    splits, leaf_table, offsets = mrpt.build_trees(projs, depth)
    a, b = sq8.sq8_train(x)
    leaf_flat = leaf_table.reshape(-1).astype(np.int32)
    q = x[rng.integers(0, n, 16)] \
        + rng.normal(size=(16, 128)).astype(np.float32) * 0.05
    q[:, d:] = 0
    return dict(db=x, sq=np.einsum("ij,ij->i", x, x), bases=bases,
                splits=splits, mirror=sq8.sq8_encode_np(x, a, b)[leaf_flat],
                a=a, b=b, leaf_flat=leaf_flat, offsets=offsets), q, depth, \
        int(np.diff(offsets).max())


@pytest.mark.cuda
def test_mrpt_query_mirror_on_card_matches_cpu(card):
    from smqtk_indexing_tpu_torch.ops import ivf_scan, mrpt
    state, q, depth, leaf_max = _mrpt_state()
    out = []
    for dev in (card, torch.device("cpu")):
        names = ("db", "sq", "bases", "splits", "mirror", "a", "b",
                 "leaf_flat", "offsets")
        before = ivf_scan.LAUNCHES["ivf_list_scores"]
        d_, r_ = mrpt.mrpt_query_mirror(
            *(torch.from_numpy(np.ascontiguousarray(state[x])).to(dev)
              for x in names), torch.from_numpy(q).to(dev), k=10,
            depth=depth, leaf_max=leaf_max)
        launched = ivf_scan.LAUNCHES["ivf_list_scores"] - before
        out.append((d_.cpu().numpy(), r_.cpu().numpy(), launched))
    (d_g, r_g, n_g), (d_c, r_c, n_c) = out
    assert (n_g, n_c) == (1, 0)
    assert_same_neighbours(r_g, d_g, r_c, d_c, rtol=DIST_RTOL, atol=1e-5)
    for row in r_g:
        assert len(set(row.tolist())) == 10


@pytest.mark.cuda
@pytest.mark.parametrize("switch", [False, True])
def test_mrpt_index_on_card_with_and_without_switch(card, monkeypatch,
                                                   switch):
    from smqtk_indexing_tpu_torch.data import DataMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (
        MRPTNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    if switch:
        monkeypatch.setenv("SMQTK_TPU_NO_MRPT_MIRROR", "1")
    rng = np.random.default_rng(22)
    centers = rng.normal(size=(20, 40)).astype(np.float32) * 3
    x = centers[rng.integers(0, 20, 4000)] \
        + rng.normal(size=(4000, 40)).astype(np.float32) * 0.4
    elems = [DescriptorMemoryElement(i, v) for i, v in enumerate(x)]
    queries = [DescriptorMemoryElement(("q", i), x[i * 7] + 0.01)
               for i in range(24)]
    elem = DataMemoryElement()
    cpu = MRPTNearestNeighborsIndex(index_element=elem, num_trees=6,
                                    depth=4, random_seed=0, device="cpu")
    cpu.build_index(elems)
    gpu = MRPTNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), num_trees=6,
        depth=4, random_seed=0, device="cuda")
    assert (gpu._mirror is None) == switch == (cpu._mirror is None)
    before = ivf_scan.LAUNCHES["ivf_list_scores"]
    res = gpu.nn_many(queries, 10)
    assert ivf_scan.LAUNCHES["ivf_list_scores"] - before == (0 if switch
                                                             else 1)
    ref = cpu.nn_many(queries, 10)
    for (e_g, d_g), (e_c, d_c) in zip(res, ref):
        assert_same_neighbours([[e.uuid() for e in e_g]], [d_g],
                               [[e.uuid() for e in e_c]], [d_c],
                               rtol=DIST_RTOL, atol=1e-5)


# ---------------------------------------------------------------------------
# the multi-device layer: each sharded route on two shards of one card
# (device=["cuda:0", "cuda:0"]) against the same route on two CPU shards,
# trained state carried by the CPU index's payload.
# ---------------------------------------------------------------------------

def _sharded_pair(cls, n_devices=2, gpu_device=None, **kw):
    """(card index, CPU index) with ``n_devices`` shards, the card one
    (on ``gpu_device``, default ``["cuda:0"] * n_devices``) loading the
    CPU one's payload."""
    from smqtk_indexing_tpu_torch.data import DataMemoryElement
    rng = np.random.default_rng(31)
    centres = rng.random((32, 40), dtype=np.float32)
    x = centres[rng.integers(0, 32, 6000)] \
        + rng.normal(size=(6000, 40)).astype(np.float32) / 12
    elems = [DescriptorMemoryElement(i, v) for i, v in enumerate(x)]
    elem = DataMemoryElement()
    cpu = cls(index_element=elem, n_devices=n_devices, device="cpu", **kw)
    cpu.build_index(elems)
    gpu = cls(index_element=DataMemoryElement(elem.get_bytes()),
              n_devices=n_devices,
              device=gpu_device or ["cuda:0"] * n_devices, **kw)
    queries = [DescriptorMemoryElement(("q", i), x[i * 13] + 0.01)
               for i in range(16)]
    return gpu, cpu, queries


def _same_results(gpu, cpu, queries, atol=1e-5):
    res, ref = gpu.nn_many(queries, 10), cpu.nn_many(queries, 10)
    assert_same_neighbours([[e.uuid() for e in r[0]] for r in res],
                           [r[1] for r in res],
                           [[e.uuid() for e in r[0]] for r in ref],
                           [r[1] for r in ref], rtol=DIST_RTOL, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "sq8"])
def test_sharded_flat_on_card_matches_cpu(card, dtype):
    gpu, cpu, queries = _sharded_pair(FlatNearestNeighborsIndex,
                                      dtype=dtype)
    assert gpu._store._dev[0].device.type == "cuda"
    before = dict(fused_scan.LAUNCHES)
    _same_results(gpu, cpu, queries)
    # Under a mesh the flat store takes the plain per-shard scan.
    assert _launched(before) == {}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,rerank,kernel", [
    ("sq8", "score", "ivf_list_scores_tiled"),
    ("sq8", "exact", "seg_gather_tiled"),
    ("pq8", "score", "ivf_list_scores_tiled_pq")])
def test_sharded_code_tier_on_card_matches_cpu(card, dtype, rerank,
                                               kernel):
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    gpu, cpu, queries = _sharded_pair(
        IvfNearestNeighborsIndex, n_lists=16, nprobe=4, random_seed=0,
        dtype=dtype, storage="code", rerank=rerank)

    def launches():
        return ivf_scan.LAUNCHES[kernel] if kernel in ivf_scan.LAUNCHES \
            else fused_scan.LAUNCHES[(kernel, "copy")]
    before = launches()
    gpu.nn_many(queries, 10)
    assert launches() - before == 2                # one launch a shard
    _same_results(gpu, cpu, queries, atol=1e-4)


@pytest.mark.cuda
def test_sharded_rows_tier_mrpt_and_hamming_on_card_match_cpu(card):
    from smqtk_indexing_tpu_torch.models.hash_index.linear import (
        LinearHashIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (
        MRPTNearestNeighborsIndex,
    )
    _same_results(*_sharded_pair(IvfNearestNeighborsIndex, n_lists=16,
                                 nprobe=4, random_seed=0))
    _same_results(*_sharded_pair(MRPTNearestNeighborsIndex, num_trees=6,
                                 depth=4, random_seed=0))
    rng = np.random.default_rng(32)
    codes = rng.random((20000, 32)) > 0.5
    out = []
    for device in (["cuda:0"] * 4, "cpu"):
        index = LinearHashIndex(n_devices=4, device=device)
        index.build_index(codes)
        out.append([index.nn(h, 12)[1] for h in codes[:8]])
    assert out[0] == out[1]


@pytest.mark.cuda
def test_sharded_indexes_on_two_cards_keep_the_current_device(card):
    """The kernels' C entry points select their card with
    ``cudaSetDevice``; each wrapper launches inside ``torch.cuda.device``
    of its operands, so a shard on ``cuda:1`` gives the caller's current
    device back. Without that, an index on ``device="cuda"`` put its
    single-device state on one card and its queries on another (the rows
    tier's residual PQ transform raised)."""
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    torch.cuda.set_device(0)
    for kw in (dict(dtype="sq8", storage="code", rerank="exact"),
               dict(dtype="pq4", storage="code", rerank="score"),
               dict(dtype="pq4", storage="rows", pq_residual=True)):
        gpu, cpu, queries = _sharded_pair(
            IvfNearestNeighborsIndex, gpu_device="cuda", n_lists=16,
            nprobe=4, random_seed=0, **kw)
        assert [str(d) for d in gpu._mesh.flat] == ["cuda:0", "cuda:1"]
        _same_results(gpu, cpu, queries)
        assert torch.cuda.current_device() == 0


@pytest.mark.cuda
def test_sharded_kmeans_step_on_card_matches_cpu(card):
    from smqtk_indexing_tpu_torch.parallel import mesh, sharded_kmeans_step
    rng = np.random.default_rng(33)
    x = rng.normal(size=(8192, 32)).astype(np.float32)
    valid = rng.random(8192) > 0.05
    c = x[:64].copy()
    out = []
    for m in (mesh.make_mesh(2, devices=["cuda:0"] * 2),
              mesh.make_mesh(2, device="cpu")):
        cents, assigns = sharded_kmeans_step(
            m, mesh.shard_rows(m, x), mesh.shard_rows(m, valid), c)
        out.append((cents.cpu().numpy(),
                    torch.cat([a.cpu() for a in assigns]).numpy()))
    assert (out[0][1] == out[1][1]).mean() > 0.999
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# reproducible training: two builds from one seed, with no determinism
# switch, bit for bit (k-means sums in int64 fixed point, ops/kmeans.py)
# ---------------------------------------------------------------------------

#: Trained state two builds from one seed must share bit for bit.
_BUILD_STATE = ("_centroids_np", "_assign_host", "_code_a", "_code_b",
                "_code_cb", "_code_rot", "_dev3", "_s2t", "_slot_table")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [
    dict(dtype="sq8", storage="code", rerank="score", n_lists=64, nprobe=4),
    dict(dtype="opq16", storage="code", pq_residual=True, rerank="exact",
         n_lists=64, nprobe=8)], ids=["ivf_sq8", "ivf_opq16_residual"])
def test_two_builds_from_one_seed_are_bit_equal(card, kw):
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    assert not torch.are_deterministic_algorithms_enabled()
    rng = np.random.default_rng(41)
    centres = rng.normal(size=(64, 96)).astype(np.float32)
    x = centres[rng.integers(0, 64, 30000)] \
        + rng.normal(size=(30000, 96)).astype(np.float32) * 0.3
    elems = [DescriptorMemoryElement(i, v) for i, v in enumerate(x)]
    queries = [DescriptorMemoryElement(("q", i), x[i * 97] + 0.05)
               for i in range(64)]
    out = []
    for _ in range(2):
        index = IvfNearestNeighborsIndex(kmeans_iterations=10,
                                         random_seed=0, device="cuda", **kw)
        index.build_index(elems)
        res = index.nn_many(queries, 10)
        out.append((index, [[e.uuid() for e in r[0]] for r in res],
                    np.array([r[1] for r in res])))
    (a, ua, da), (b, ub, db) = out
    for name in _BUILD_STATE:
        x_a, x_b = getattr(a, name, None), getattr(b, name, None)
        if isinstance(x_a, torch.Tensor):
            assert torch.equal(x_a, x_b), name
        elif x_a is None:
            assert x_b is None, name
        else:
            np.testing.assert_array_equal(np.asarray(x_a), np.asarray(x_b),
                                          err_msg=name)
    assert ua == ub
    np.testing.assert_array_equal(da, db)


@pytest.mark.cuda
def test_kmeans_on_card_equals_cpu_bit_for_bit(card):
    # Integer sums are exact: with the same assignments, the card and the
    # CPU train the same centroids.
    from smqtk_indexing_tpu_torch.ops import kmeans
    rng = np.random.default_rng(42)
    centres = rng.normal(size=(16, 32)).astype(np.float32) * 8
    x = centres[rng.integers(0, 16, 20000)] \
        + rng.normal(size=(20000, 32)).astype(np.float32)
    valid = torch.from_numpy(rng.random(20000) > 0.02)
    out = [kmeans.kmeans_lloyd(torch.from_numpy(x).to(dev),
                               valid.to(dev),
                               torch.from_numpy(x[:16]).to(dev), n_iter=5)
           for dev in (card, "cpu")]
    assert torch.equal(out[0][1].cpu(), out[1][1])
    assert torch.equal(out[0][0].cpu(), out[1][0])


# ---------------------------------------------------------------------------
# the host-streamed tier against the device store on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["euclidean", "cosine", "inner_product",
                                    "hik"])
def test_host_stream_matches_device_store_on_card(card, metric):
    from smqtk_indexing_tpu_torch.ops.store import (
        HostStreamedVectorStore, VectorStore,
    )
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS
    rng = np.random.default_rng(0)
    n, d = 5000, 24
    db = rng.random((n, d)).astype(np.float32)
    dev = VectorStore(device="cuda")
    hst = HostStreamedVectorStore(block_rows=1024, device="cuda")
    for store in (dev, hst):
        store.build(db, list(range(n)))
        store.remove(list(range(3, n, 11)))
    q = rng.random((33, d)).astype(np.float32)
    d1, u1, _ = dev.knn(q, 9, metric)
    COUNTERS.reset()
    d2, u2, _ = hst.knn(q, 9, metric)
    assert COUNTERS.get("host_stream.blocks") == 5
    assert u1 == u2
    # The same exact formula on the same rows (inner_product and cosine
    # by K1's elementwise one): bit for bit for hik, which both stores
    # score with the same plain formula; the device store's fused metrics
    # sum it in the stage-2 kernel's order (csrc/rerank_segments.cu), so
    # within STAGE2_RTOL there (cosine as similarities, _held).
    if metric == "hik":
        np.testing.assert_array_equal(d2, d1)
    else:
        np.testing.assert_allclose(_held(d2, metric), _held(d1, metric),
                                   rtol=STAGE2_RTOL)
    # Again, with the pinned staging buffers reused.
    d3, u3, _ = hst.knn(q, 9, metric)
    assert u3 == u2
    np.testing.assert_array_equal(d3, d2)


@pytest.mark.cuda
def test_ivf_100m_example_mini_on_card(card, monkeypatch):
    import importlib
    monkeypatch.setenv("SMQTK_IVF100M_MINI", "1")
    for name in ("CHUNKS", "NO_SQ8", "NO_PQ", "OPQ", "RAW_PQ"):
        monkeypatch.delenv("SMQTK_IVF100M_" + name, raising=False)
    from smqtk_indexing_tpu_torch.examples import ivf_100m
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    mod = importlib.reload(ivf_100m)
    try:
        before = dict(ivf_scan.LAUNCHES)
        records = mod.main(device="cuda")
        mod.check_recall(records)
        assert ivf_scan.LAUNCHES["ivf_list_scores_tiled"] \
            > before["ivf_list_scores_tiled"]
        assert ivf_scan.LAUNCHES["ivf_list_scores_tiled_pq"] \
            > before["ivf_list_scores_tiled_pq"]
        assert all(r["peak_device_bytes"] > 0 for r in records)
    finally:
        monkeypatch.undo()
        importlib.reload(ivf_100m)


@pytest.mark.cuda
@pytest.mark.parametrize("rerank", ["score", "gather"])
def test_k7_under_the_virtual_centroid_query(card, rerank):
    # ivf_scan.ivf_query_dma_tiled on the card: K7 (and K3 in gather mode)
    # launches, distances bit-equal to the slot-table form's on the card
    # (the same windows), rows too but where they tie, and the CPU's
    # plain run within DIST_RTOL.
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    lay = chunked_tiled_layout(seed=31)
    db3, s2t, a, b, cents = (lay[key] for key in ("db3", "s2t", "a", "b",
                                                   "cents"))
    v_tile, v_col, v_len, v_orig, first_virt = lay["csr"]
    q = near_rows(lay["dq"], 48, seed=32)
    nprobe = 3
    budget = ivf_scan.probe_budget(v_orig, nprobe)
    table = ivf_scan.build_slot_table(v_orig, cents.shape[0])

    def run(dev, form):
        t = [torch.from_numpy(np.ascontiguousarray(x)).to(dev) for x in
             (db3, s2t, a, b)]
        vt, vc, vl, qd = (torch.from_numpy(x).to(dev)
                          for x in (v_tile, v_col, v_len, q))
        if form == "virtual":
            return ivf_scan.ivf_query_dma_tiled(
                *t, torch.from_numpy(cents[v_orig]).to(dev), vt, vc, vl, qd,
                k=10, n_probe=budget,
                first_virt=torch.from_numpy(first_virt).long().to(dev),
                nprobe_orig=nprobe, rerank=rerank)
        return ivf_scan.ivf_query_dma_tiled_table(
            *t, torch.from_numpy(cents).to(dev),
            torch.from_numpy(table).long().to(dev), vt, vc, vl, qd, k=10,
            nprobe_orig=nprobe, rerank=rerank)

    before = dict(ivf_scan.LAUNCHES)
    k3_before = fused_scan.LAUNCHES["seg_gather_tiled", "copy"]
    d_v, r_v = run(card, "virtual")
    torch.cuda.synchronize()
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled"] \
        == before["ivf_list_scores_tiled"] + 1
    assert fused_scan.LAUNCHES["seg_gather_tiled", "copy"] - k3_before \
        == (rerank == "gather")
    d_t, r_t = run(card, "table")
    assert torch.equal(d_v, d_t)
    assert_same_neighbours(r_v.cpu(), d_v.cpu(), r_t.cpu(), d_t.cpu(),
                           rtol=0.0)
    d_c, r_c = run("cpu", "virtual")
    if rerank == "gather":
        assert_same_neighbours(r_v.cpu(), d_v.cpu(), r_c, d_c,
                               rtol=DIST_RTOL, atol=1e-5)
        return
    # Score mode reads the surrogate s2 - 2 <t, u> + ||q - b||^2: K7's and
    # the plain version's f32 sums differ by STAGE1_RTOL of its terms'
    # magnitude, which the square root divides by 2 d.
    rq2 = ((q - b) ** 2).sum(1)
    for i in range(q.shape[0]):
        tol = STAGE1_RTOL * (rq2[i] + s2t.max()) / (2.0 * d_c[i, 0].item())
        assert_same_neighbours(r_v[i:i + 1].cpu(), d_v[i:i + 1].cpu(),
                               r_c[i:i + 1], d_c[i:i + 1], rtol=0.0,
                               atol=tol)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [64, 40])
def test_bf16_stage2_on_card(card, b):
    # flat_topk_fused(db_seg_lo=...) over a bf16 database, its rows as
    # their own mirror: K1's bf16 form on the tensor cores, then the
    # cohort products (B = 64) or the per-query product (B = 40); the
    # float64 top-k over the stored rows, distances within DIST_RTOL, and
    # the CPU's run.
    n, d, k = 8192, 128, 10
    rng = np.random.default_rng(32)
    db = torch.from_numpy((rng.normal(size=(n, d)) * 3).astype(np.float32)) \
        .to(torch.bfloat16)
    x = db.float().numpy().astype(np.float64)
    q = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    sq = torch.from_numpy((x * x).sum(1).astype(np.float32))
    valid = torch.from_numpy(rng.random(n) > 0.02)

    def run(dev):
        dv = db.to(dev)
        return fused_scan.flat_topk_fused(
            dv, sq.to(dev), valid.to(dev), torch.from_numpy(q).to(dev), k=k,
            db_seg_lo=dv.view(n // 128, 128, d))

    before = dict(fused_scan.LAUNCHES)
    d_g, r_g = run(card)
    torch.cuda.synchronize()
    assert _launched(before) == {("segment_minima", "wgmma"): 1}
    d2 = ((q.astype(np.float64)[:, None, :] - x[None]) ** 2).sum(-1)
    d2[:, ~valid.numpy()] = np.inf
    ref = np.argsort(d2, axis=1, kind="stable")[:, :k]
    assert_same_neighbours(r_g.cpu().numpy(), d_g.cpu().numpy(), ref,
                           np.sqrt(np.take_along_axis(d2, ref, 1)),
                           rtol=DIST_RTOL)
    d_c, r_c = run("cpu")
    assert_same_neighbours(r_g.cpu(), d_g.cpu(), r_c, d_c, rtol=DIST_RTOL)
