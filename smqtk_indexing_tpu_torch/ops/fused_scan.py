"""
Exact exhaustive top-k through a fused stage-1 kernel and an exact
stage-2 re-rank: the PyTorch counterpart of
``smqtk_indexing_tpu/ops/pallas_scan.py`` (named for what it does, since
there is no Pallas here).

Stage 1, ``segment_minima``: per query, the minimum of the L2 surrogate
``||x||^2 - 2<q,x> + penalty`` over every 128-row segment, so the (B, N)
score matrix never reaches memory. On a CUDA tensor it runs the
hand-written Hopper kernel ``csrc/segment_minima.cu`` (the port of
``pallas_scan.segment_minima`` -> ``_scan_kernel``, ``:102-241``); on a
CPU tensor, its plain PyTorch version ``segment_minima_reference``.

Stage 2 (``pallas_scan.py:619-700``, the f32 form): the top ``s_keep``
segments by minimum, a gather of their rows, exact per-metric distances
in the difference form, and the final top-k. Exactness of the
pre-selection: every row of the true top-k scores <= theta (the k-th
best), so its segment's minimum is <= theta; at most k distinct segment
minima can be <= theta, so the best ``k + 8`` segments hold every true
top-k row, with slack for ties.

The bf16 ``db_seg_lo`` stage-2 form (``pallas_scan.py:702-755``) is not
ported: the store never takes it.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from smqtk_indexing_tpu_torch.ops import _kernels
from smqtk_indexing_tpu_torch.ops.device import require_full_f32
from smqtk_indexing_tpu_torch.utils.tracing import trace_span

#: Segment width: rows collapsing to one stage-1 output element.
SEG = 128

#: Metrics with a matmul-form surrogate, served by this path.
FUSED_METRICS = ("euclidean", "inner_product", "cosine")

#: Launches of the CUDA stage-1 kernel in this process. The wrapper adds
#: one where it launches the kernel and nowhere else.
LAUNCHES = 0

#: Cap on the (B, C) f32 score block of ``segment_minima_reference``.
REFERENCE_BYTES = 1 << 28

#: Cap on stage 2's (b, s_keep * 128, d) f32 candidate block: queries run
#: in blocks under it (eager PyTorch materialises the gather XLA fused).
STAGE2_BYTES = 1 << 28


def _q_kernel_dtype(q: torch.Tensor, db_dtype: torch.dtype) -> torch.Tensor:
    """Stage-1 query operand, f32: rounded to bf16 first for a bf16
    database (``pallas_scan._q_kernel_dtype``), so that every product of
    two bf16 values is exact in f32."""
    if db_dtype == torch.bfloat16:
        return q.to(torch.bfloat16).float()
    return q.float()


def _check_stage1(db, db_sq, penalty, q) -> None:
    if db.dim() != 2 or q.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(
            f"segment_minima: db {tuple(db.shape)} and q {tuple(q.shape)} "
            "must be (N, d) and (B, d)")
    n = db.shape[0]
    if n % SEG:
        raise ValueError(f"segment_minima: N={n} is not a multiple of {SEG}")
    if db_sq.shape != (n,) or penalty.shape != (n,):
        raise ValueError("segment_minima: db_sq and penalty must be (N,)")
    if db.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"segment_minima: db dtype {db.dtype} is not "
                        "float32 or bfloat16")
    if (db_sq.dtype, penalty.dtype, q.dtype) != (torch.float32,) * 3:
        raise TypeError("segment_minima: db_sq, penalty and q must be "
                        "float32")


def segment_minima(db: torch.Tensor, db_sq: torch.Tensor,
                   penalty: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """
    Stage 1: per-query, per-128-row-segment minima of the L2 surrogate.

    :param db: (N, d) row-major database, f32 or bf16, N % 128 == 0.
    :param db_sq: (N,) f32 squared norms (zeros for inner_product/cosine).
    :param penalty: (N,) f32, 0 for live rows and +inf for dead ones.
    :param q: (B, d) f32 queries (rounded to bf16 for a bf16 database).
    :return: (B, N // 128) f32 segment minima.
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built
        or launched. There is no fallback to the plain version.
    """
    devices = {t.device for t in (db, db_sq, penalty, q)}
    if len(devices) != 1:
        raise ValueError(f"segment_minima: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return segment_minima_reference(db, db_sq, penalty, q)
    if dev.type == "cuda":
        return _segment_minima_cuda(db, db_sq, penalty, q)
    raise ValueError(f"segment_minima: unsupported device {dev}")


def segment_minima_reference(db: torch.Tensor, db_sq: torch.Tensor,
                             penalty: torch.Tensor,
                             q: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`segment_minima`, on any device:
    row chunks of f32 scores, each reduced to its segment minima at once,
    so it never holds more than ``REFERENCE_BYTES`` of scores. On a card
    the caller keeps TF32 products off (``require_full_f32``)."""
    _check_stage1(db, db_sq, penalty, q)
    n = db.shape[0]
    b = q.shape[0]
    qk = _q_kernel_dtype(q, db.dtype)
    require_full_f32(qk)
    out = torch.empty((b, n // SEG), dtype=torch.float32, device=db.device)
    rows = max(SEG, REFERENCE_BYTES // (4 * max(b, 1)) // SEG * SEG)
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        ip = qk @ db[lo:hi].float().T
        s = (db_sq[lo:hi] - 2.0 * ip) + penalty[lo:hi]
        out[:, lo // SEG:hi // SEG] = s.view(b, -1, SEG).amin(dim=-1)
    return out


def _segment_minima_cuda(db, db_sq, penalty, q) -> torch.Tensor:
    """Launch ``csrc/segment_minima.cu`` on the current stream."""
    global LAUNCHES
    _check_stage1(db, db_sq, penalty, q)
    n, d = db.shape
    b = q.shape[0]
    if d % 128:
        raise ValueError(f"segment_minima: d={d} is not a multiple of 128 "
                         "(stores pad it with pad_dim)")
    qk = _q_kernel_dtype(q, db.dtype).contiguous()
    for name, t in (("db", db), ("db_sq", db_sq), ("penalty", penalty)):
        if not t.is_contiguous():
            raise ValueError(f"segment_minima: {name} is not contiguous")
    if any(t.data_ptr() % 16 for t in (db, qk)):
        raise ValueError("segment_minima: db and q must be 16-byte aligned")
    if -(-b // 128) * (n // SEG) >= 2 ** 31:
        raise ValueError("segment_minima: grid exceeds 2^31 blocks")
    out = torch.empty((b, n // SEG), dtype=torch.float32, device=db.device)
    lib = _kernels.library()
    name = ("segment_minima_bf16" if db.dtype == torch.bfloat16
            else "segment_minima_f32")
    stream = torch.cuda.current_stream(db.device).cuda_stream
    err = getattr(lib, name)(
        qk.data_ptr(), db.data_ptr(), db_sq.data_ptr(), penalty.data_ptr(),
        out.data_ptr(), b, n, d, db.device.index, stream)
    _kernels.check(err, name)
    LAUNCHES += 1
    return out


def topk_smallest(m: torch.Tensor, kk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``kk`` smallest over the rows of (B, W)
    (``pallas_scan.topk_smallest``, ``:547-574``).

    :return: (values ascending, int64 indices), each (B, kk).
    """
    return torch.topk(m, kk, dim=1, largest=False, sorted=True)


def segments_kept(k: int, n: int) -> int:
    """Segments stage 2 re-ranks for top-``k`` over ``n`` rows. Exactness
    needs only k - 1 segments; +8 absorbs ties at the k-th score."""
    return min(max(k + 8, 16), n // SEG)


def select_segments(minima: torch.Tensor, s_keep: int) -> torch.Tensor:
    """(B, s_keep) ids of the segments with the smallest minima; -1 where
    the minimum is +inf (no live row)."""
    smin, sid = topk_smallest(minima, s_keep)
    return torch.where(torch.isinf(smin), -1, sid)


def normalized_rows(db: torch.Tensor, db_norm: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row-normalised copy of ``db`` (zero rows stay zero), in ``dtype``
    (default f32): cosine's stage-1 matrix."""
    nrm = torch.where(db_norm == 0, 1.0, db_norm)
    return (db.float() / nrm[:, None]).to(dtype or torch.float32)


def _exact_dists(metric: str, cand: torch.Tensor, q: torch.Tensor,
                 q_norm: torch.Tensor, cn: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Exact distances of (b, M, d) f32 candidates to (b, d) queries.
    ``cand`` is a fresh gather and is overwritten (euclidean)."""
    if metric == "euclidean":
        # Difference form: ||x||^2 - 2<q,x> + ||q||^2 cancels at tiny
        # distances (ops/scan.py:238-241).
        diff2 = cand.sub_(q[:, None, :]).square_()
        return torch.sqrt(torch.clamp(diff2.sum(-1), min=0.0))
    # Elementwise product and sum, as pallas_scan.py:671-674: full f32
    # without a cuBLAS precision switch.
    ip = cand.mul_(q[:, None, :]).sum(-1)
    if metric == "inner_product":
        return -ip
    denom = q_norm[:, None] * cn
    sim = torch.clamp(ip / torch.where(denom == 0, 1.0, denom), -1.0, 1.0)
    return 2.0 * torch.arccos(sim) / math.pi


def rerank_segments(db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                    sid: torch.Tensor, *, k: int, metric: str = "euclidean",
                    db_norm: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Stage 2: gather the kept segments' rows, exact distances, final top-k.
    Runs over blocks of queries so that the (b, s_keep * 128, d) f32
    candidate block stays under ``STAGE2_BYTES``.

    :param sid: (B, s_keep) segment ids from :func:`select_segments`.
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pad).
    """
    n, d = db.shape
    b, s_keep = sid.shape
    m = s_keep * SEG
    q = q.float()
    q_norm = torch.sqrt((q * q).sum(-1))
    q_block = max(1, STAGE2_BYTES // (4 * m * d))
    db_seg = db.view(n // SEG, SEG, d)
    valid_seg = valid.view(n // SEG, SEG)
    norm_seg = db_norm.view(n // SEG, SEG) if metric == "cosine" else None
    lane = torch.arange(SEG, device=db.device)
    out_d, out_r = [], []
    for lo in range(0, b, q_block):
        hi = min(lo + q_block, b)
        sb = sid[lo:hi]
        sc = torch.clamp(sb, min=0)
        rows = (sc[..., None] * SEG + lane).reshape(hi - lo, m)
        alive = ((sb[..., None] >= 0) & valid_seg[sc]).reshape(hi - lo, m)
        cand = db_seg[sc].reshape(hi - lo, m, d).float()
        cn = norm_seg[sc].reshape(hi - lo, m) if norm_seg is not None \
            else None
        exact = _exact_dists(metric, cand, q[lo:hi], q_norm[lo:hi], cn)
        exact = torch.where(alive, exact, math.inf)
        dd, sel = topk_smallest(exact, k)
        rr = torch.gather(rows, 1, sel)
        out_d.append(dd)
        out_r.append(torch.where(torch.isinf(dd), -1, rr))
    return torch.cat(out_d), torch.cat(out_r)


def flat_topk_fused(db: torch.Tensor, db_sq: torch.Tensor,
                    valid: torch.Tensor, q: torch.Tensor, *, k: int,
                    metric: str = "euclidean",
                    db_mirror: Optional[torch.Tensor] = None,
                    db_norm: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Exact exhaustive top-k: fused stage 1 + exact f32 stage 2
    (``pallas_scan.flat_topk_fused``, ``:577-700``, without ``db_seg_lo``).

    - 'euclidean': the kernel's ``sq - 2 ip`` surrogate;
    - 'inner_product': zero norms degrade the surrogate to ``-2 ip``;
    - 'cosine': stage 1 scans the ROW-NORMALISED matrix with a normalised
      query (surrogate ``-2 cos``, monotone in angular distance); stage 2
      computes the exact angular distance from the raw rows.

    :param db: (N, d) database, f32 or bf16, N % 128 == 0.
    :param db_sq: (N,) f32 squared row norms.
    :param valid: (N,) bool liveness mask.
    :param q: (B, d) f32 queries.
    :param db_mirror: (N, d) matrix stage 1 scans in place of ``db``: the
        row-normalised mirror for cosine (built once per call from
        ``db_norm`` when None). Ignored by the other metrics, which scan
        ``db`` itself: no transposed copy is needed.
    :param db_norm: (N,) f32 row norms; required for cosine.
    :return: (dists (B, k) f32 ascending, rows (B, k) int64); entries past
        the live rows are +inf / -1.
    """
    if metric not in FUSED_METRICS:
        raise ValueError(f"flat_topk_fused serves {FUSED_METRICS}, "
                         f"not {metric!r}")
    n = db.shape[0]
    q = q.float()
    q_stage1 = q
    stage1_db = db
    if metric != "euclidean":
        db_sq = torch.zeros_like(db_sq)
    if metric == "cosine":
        if db_norm is None:
            raise ValueError("cosine needs db_norm")
        q_norm = torch.sqrt((q * q).sum(-1))
        q_stage1 = q / torch.where(q_norm == 0, 1.0, q_norm)[:, None]
        stage1_db = db_mirror if db_mirror is not None \
            else normalized_rows(db, db_norm)
    penalty = torch.where(valid, 0.0, math.inf).to(torch.float32)
    with trace_span("fused_scan.stage1"):
        minima = segment_minima(stage1_db, db_sq, penalty, q_stage1)
        sid = select_segments(minima, segments_kept(k, n))
    with trace_span("fused_scan.stage2"):
        return rerank_segments(db, valid, q, sid, k=k, metric=metric,
                               db_norm=db_norm)
