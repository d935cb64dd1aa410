"""
Exhaustive kNN scan with a carried running top-k, in plain PyTorch.

Counterpart of ``smqtk_indexing_tpu/ops/scan.py:26-144, 180-291``
(``METRICS``, ``_chunk_scores``, ``_finalize``, ``flat_topk``,
``exact_rerank_decoded``, ``pad_to_k``, ``_exact_selected``,
``rerank_exact``). The IVF query functions (``ops/ivf.py``,
``ops/ivf_scan.py``) finish through ``_exact_selected``,
``exact_rerank_decoded`` and ``pad_to_k``. Row blocks stream
through a product (or an elementwise pass for hik / chi_square), each
block's surrogate scores merge into a running (B, k) best set, and true
distances are rebuilt only for the k winners, so the full (B, N) distance
matrix never exists. This path serves all five metrics on any device;
the vector store sends hik and chi_square here (they have no matmul form)
and the matmul metrics to ``ops/fused_scan.flat_topk_fused``.

Eager PyTorch materialises what XLA fuses: hik and chi_square build a
(B, C, d) intermediate per block, so their block size is capped by
``ELEMENTWISE_BYTES``.
"""
from __future__ import annotations

import math

import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32

METRICS = ("euclidean", "inner_product", "cosine", "hik", "chi_square")

#: Rows per streamed block for the matmul metrics.
DEFAULT_CHUNK = 65536

#: Cap on the (B, C, d) f32 intermediate of the elementwise metrics.
ELEMENTWISE_BYTES = 1 << 28

#: Segment width of the compressed scans' streamed stage 1 (the fused
#: kernel's SEG, so the exactness argument is shared).
SEG_W = 128

#: Cap on ``codec_topk``'s stage-2 candidate block: queries run in blocks
#: under it.
STAGE2_BYTES = 1 << 28


def _chunk_scores(metric: str, q: torch.Tensor, q_norm: torch.Tensor,
                  x: torch.Tensor, x_sq: torch.Tensor,
                  x_norm: torch.Tensor) -> torch.Tensor:
    """
    (B, C) f32 surrogate scores, lower = closer, monotone in the true
    distance per query. ``q`` carries the storage dtype's rounding (as the
    JAX package casts queries to the database dtype) but every product and
    sum runs in f32: bf16 x bf16 products are exact in f32.
    """
    q = q.float()
    x = x.float()
    if metric == "hik":
        return 1.0 - torch.minimum(q[:, None, :], x[None, :, :]).sum(-1)
    if metric == "chi_square":
        s = q[:, None, :] + x[None, :, :]
        dlt = q[:, None, :] - x[None, :, :]
        pos = s > 0
        return torch.where(pos, dlt * dlt / torch.where(pos, s, 1.0),
                           0.0).sum(-1)
    require_full_f32(q)
    ip = q @ x.T
    if metric == "euclidean":
        # ||q||^2 omitted: constant per query, added in _finalize.
        return x_sq[None, :] - 2.0 * ip
    if metric == "inner_product":
        return -ip
    if metric == "cosine":
        denom = q_norm[:, None] * x_norm[None, :]
        denom = torch.where(denom == 0, 1.0, denom)
        return -(ip / denom)
    raise ValueError(f"Unknown metric '{metric}'. Must be one of {METRICS}.")


def _finalize(metric: str, scores: torch.Tensor,
              q_sq: torch.Tensor) -> torch.Tensor:
    """Map selected surrogate scores back to true distances."""
    if metric == "euclidean":
        return torch.sqrt(torch.clamp(scores + q_sq[:, None], min=0.0))
    if metric == "cosine":
        sim = torch.clamp(-scores, -1.0, 1.0)
        return 2.0 * torch.arccos(sim) / math.pi
    # inner_product (negated IP), hik and chi_square are already distances.
    return scores


def flat_topk(db: torch.Tensor, db_sq: torch.Tensor, db_norm: torch.Tensor,
              valid: torch.Tensor, q: torch.Tensor, *, k: int,
              metric: str = "euclidean", chunk: int = DEFAULT_CHUNK):
    """
    Exhaustive top-k over a database on ``db.device``: streamed score
    blocks with a carried running top-k.

    :param db: (N, d) database (f32 or bf16; padding rows zero).
    :param db_sq: (N,) f32 squared L2 norms of rows.
    :param db_norm: (N,) f32 L2 norms of rows.
    :param valid: (N,) bool row-liveness mask (False rows never selected).
    :param q: (B, d) f32 queries (d matching db's padded dim).
    :param k: Neighbours per query (<= N).
    :param metric: One of METRICS.
    :param chunk: Streamed block size for the matmul metrics.
    :return: (dists (B, k) f32 ascending, rows (B, k) int64). Entries
        beyond the number of valid rows carry +inf distance / row -1.
    """
    if metric not in METRICS:
        raise ValueError(
            f"Unknown metric '{metric}'. Must be one of {METRICS}.")
    n, d = db.shape
    b = q.shape[0]
    q = q.float()
    q_sq = (q * q).sum(-1)
    q_norm = torch.sqrt(q_sq)
    qc = q.to(db.dtype)
    if metric in ("hik", "chi_square"):
        chunk = min(chunk, max(1, ELEMENTWISE_BYTES // (4 * b * d)))

    best_s = torch.full((b, k), math.inf, dtype=torch.float32,
                        device=db.device)
    best_r = torch.full((b, k), -1, dtype=torch.int64, device=db.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        s = _chunk_scores(metric, qc, q_norm, db[lo:hi], db_sq[lo:hi],
                          db_norm[lo:hi])
        s = torch.where(valid[None, lo:hi], s, math.inf)
        rows = torch.arange(lo, hi, device=db.device).expand(b, hi - lo)
        cand_s = torch.cat([best_s, s], dim=1)
        cand_r = torch.cat([best_r, rows], dim=1)
        best_s, sel = torch.topk(cand_s, k, dim=1, largest=False)
        best_r = torch.gather(cand_r, 1, sel)
    # A dead row's +inf may win a slot past the live rows over a -1 slot:
    # such slots are -1 whichever the top-k picked.
    best_r = torch.where(torch.isinf(best_s), -1, best_r)
    return _exact_selected(metric, db, q, q_sq, best_s, best_r)


def pad_to_k(dists: torch.Tensor, rows: torch.Tensor, k: int):
    """Honour the (B, k) return contract when a candidate budget caps the
    selection width below k: truncate to k and pad with +inf / -1."""
    b, kk = dists.shape
    d_out, r_out = dists[:, :k], rows[:, :k]
    if kk < k:
        pad = k - kk
        d_out = torch.cat(
            [d_out, torch.full((b, pad), math.inf, dtype=d_out.dtype,
                               device=d_out.device)], dim=1)
        r_out = torch.cat(
            [r_out, torch.full((b, pad), -1, dtype=r_out.dtype,
                               device=r_out.device)], dim=1)
    return d_out, r_out


def _exact_selected(metric: str, db: torch.Tensor, q: torch.Tensor,
                    q_sq: torch.Tensor, scores: torch.Tensor,
                    rows: torch.Tensor, dq=None):
    """
    True distances for the selected (B, k) rows, re-sorted ascending. For
    L2 the surrogate ``x_sq - 2ip`` cancels catastrophically at tiny
    distances, so the k winners are recomputed in the difference form from
    a (B, k, d) gather. Other metrics' surrogates finalise without
    cancellation. Slots past the live rows are +inf / -1 for every metric.

    :param dq: Optional (a, b) SQ8 codec tensors when ``db`` holds int8
        codes: the gathered rows dequantize before the exact distance.
    """
    if metric != "euclidean":
        # Unfilled slots stay +inf (cosine would map them to 2).
        return torch.where(torch.isinf(scores), math.inf,
                           _finalize(metric, scores, q_sq)), rows
    sel = db[torch.clamp(rows, min=0)].float()
    if dq is not None:
        sel = sel * dq[0] + dq[1]
    # In place: the gather is a fresh copy.
    diff2 = sel.sub_(q[:, None, :]).square_()
    exact = torch.sqrt(torch.clamp(diff2.sum(-1), min=0.0))
    # Rows never filled (index -1 / +inf surrogate) stay +inf.
    exact = torch.where(torch.isinf(scores), math.inf, exact)
    # Exact values may reorder near-ties relative to the surrogate ranking.
    exact, order = torch.sort(exact, dim=1)
    return exact, torch.gather(rows, 1, order)


def exact_rerank_decoded(x: torch.Tensor, q: torch.Tensor,
                         q_norm: torch.Tensor, best_s: torch.Tensor,
                         best_r: torch.Tensor, metric: str, k: int):
    """
    Exact re-rank of surrogate winners already decoded to f32
    (``scan.py:180-215``): per-metric distances, re-sorted, (B, k) out.

    :param x: (B, kk, d) float32 decoded candidate rows.
    :param best_s: (B, kk) surrogate scores (+inf marks empty slots).
    :param best_r: (B, kk) rows (-1 marks empty slots).
    :return: (dists (B, k) ascending, rows (B, k); +inf / -1 padding).
    """
    if metric == "euclidean":
        diff = x - q[:, None, :]
        exact = torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    elif metric == "inner_product":
        exact = -(x * q[:, None, :]).sum(-1)
    elif metric == "cosine":
        ipx = (x * q[:, None, :]).sum(-1)
        xn = torch.sqrt(torch.clamp((x * x).sum(-1), min=0.0))
        denom = q_norm[:, None] * xn
        sim = torch.clamp(ipx / torch.where(denom == 0, 1.0, denom),
                          -1.0, 1.0)
        exact = 2.0 * torch.arccos(sim) / math.pi
    elif metric == "hik":
        exact = 1.0 - torch.minimum(q[:, None, :], x).sum(-1)
    else:
        raise ValueError(f"exact_rerank_decoded: unsupported metric "
                         f"{metric!r}")
    exact = torch.where(torch.isinf(best_s) | (best_r < 0), math.inf, exact)
    out_d, sel = torch.topk(exact, min(k, exact.shape[1]), dim=1,
                            largest=False, sorted=True)
    out_r = torch.gather(best_r, 1, sel)
    out_r = torch.where(torch.isinf(out_d), -1, out_r)
    return pad_to_k(out_d, out_r, k)


def streamed_segment_minima(score_fn, n: int, chunk: int) -> torch.Tensor:
    """
    Stream row blocks of surrogate scores and keep only the minimum of
    each ``SEG_W``-row segment (``scan.py:152-177``): the plain stage 1 of
    the compressed scans.

    :param score_fn: ``(lo, hi) -> (B, hi - lo)`` scores, +inf on dead rows.
    :param n: rows, a multiple of ``SEG_W``.
    :param chunk: rows per block, a multiple of ``SEG_W``.
    :return: (B, n // SEG_W) float32 segment minima.
    """
    parts = []
    for lo in range(0, n, chunk):
        s = score_fn(lo, min(lo + chunk, n))
        parts.append(s.view(s.shape[0], -1, SEG_W).amin(-1))
    return torch.cat(parts, dim=1)


def hik_scores(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, C) histogram-intersection distances of (B, d) queries to (C, d)
    rows (callers bound B * C * d by ``ELEMENTWISE_BYTES``)."""
    return 1.0 - torch.minimum(q[:, None, :], x[None, :, :]).sum(-1)


def codec_topk(score_block, score_rows, decode_rows, valid: torch.Tensor,
               q: torch.Tensor, q_norm: torch.Tensor, *, n: int, k: int,
               metric: str, chunk: int, block: int, row_bytes: int,
               minima=None):
    """
    Exhaustive top-k over a coded database: the skeleton shared by the
    SQ8 and PQ scans (``sq8.py:150-307``, ``pq.py:340-448``).

    - ``n <= chunk`` (and no ``minima``): the surrogate of every row, and
      its top ``k + 8``.
    - Otherwise stage 1 takes per-segment minima (``minima``, or streamed
      through ``score_block``), keeps the ``k + 16`` best segments, and
      stage 2 rescores their rows through ``score_rows`` and keeps the top
      ``k + 8``. Every segment holding a true top-k row has a minimum at
      most the k-th best score; the margins absorb surrogate noise.

    The ``k + 8`` winners then re-rank exactly from ``decode_rows``.

    :param score_block: ``(lo, hi) -> (B, hi - lo)`` surrogate scores.
    :param score_rows: ``(q0, q1, rows (b, R) int64) -> (b, R)`` surrogate
        scores of queries ``q0:q1`` against their candidate rows.
    :param decode_rows: ``rows (B, kk) int64 -> (B, kk, d)`` f32 rows.
    :param valid: (n,) bool liveness.
    :param block: rows per ``score_block`` call (bounds its memory).
    :param row_bytes: stage-2 bytes per candidate row (sets its query
        block under ``STAGE2_BYTES``).
    :param minima: optional (B, n // SEG_W) stage-1 minima from a kernel.
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    """
    b = q.shape[0]
    kk = min(k + 8, n)
    dev = q.device
    if n <= chunk and minima is None:
        s = torch.cat([score_block(lo, min(lo + block, n))
                       for lo in range(0, n, block)], dim=1)
        best_s, best_r = torch.topk(torch.where(valid[None, :], s, math.inf),
                                    kk, dim=1, largest=False, sorted=True)
        best_r = torch.where(torch.isinf(best_s), -1, best_r)
    else:
        if minima is None:
            def masked(lo, hi):
                return torch.where(valid[None, lo:hi], score_block(lo, hi),
                                   math.inf)
            minima = streamed_segment_minima(masked, n, block)
        s_keep = min(k + 16, n // SEG_W)
        smin, sid = torch.topk(minima, s_keep, dim=1, largest=False,
                               sorted=True)
        sid = torch.where(torch.isinf(smin), -1, sid)
        m_rows = s_keep * SEG_W
        lane = torch.arange(SEG_W, device=dev)
        q_block = max(1, STAGE2_BYTES // (row_bytes * m_rows))
        parts_s, parts_r = [], []
        for q0 in range(0, b, q_block):
            q1 = min(q0 + q_block, b)
            sb = sid[q0:q1]
            rows = (torch.clamp(sb, min=0)[..., None] * SEG_W + lane) \
                .reshape(q1 - q0, m_rows)
            alive = (sb[..., None] >= 0).expand(-1, -1, SEG_W) \
                .reshape(q1 - q0, m_rows) & valid[rows]
            s = torch.where(alive, score_rows(q0, q1, rows), math.inf)
            sv, sel = torch.topk(s, kk, dim=1, largest=False, sorted=True)
            parts_s.append(sv)
            parts_r.append(torch.where(torch.isinf(sv), -1,
                                       torch.gather(rows, 1, sel)))
        best_s, best_r = torch.cat(parts_s), torch.cat(parts_r)
    x = decode_rows(torch.clamp(best_r, min=0))
    return exact_rerank_decoded(x, q, q_norm, best_s, best_r, metric, k)


def rerank_exact(metric: str, q: torch.Tensor,
                 cand: torch.Tensor) -> torch.Tensor:
    """Exact distances from one query (d,) to candidate rows (M, d)."""
    qb = q[None, :]
    if metric == "euclidean":
        diff = cand - qb
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    if metric == "cosine":
        qn = torch.linalg.norm(qb, dim=-1)
        cn = torch.linalg.norm(cand, dim=-1)
        denom = torch.where(qn * cn == 0, 1.0, qn * cn)
        sim = torch.clamp((cand * qb).sum(-1) / denom, -1.0, 1.0)
        return 2.0 * torch.arccos(sim) / math.pi
    if metric == "hik":
        return 1.0 - torch.minimum(qb, cand).sum(-1)
    if metric == "chi_square":
        s = qb + cand
        dlt = qb - cand
        pos = s > 0
        return torch.where(pos, dlt * dlt / torch.where(pos, s, 1.0),
                           0.0).sum(-1)
    if metric == "inner_product":
        return -(cand * qb).sum(-1)
    raise ValueError(f"Unknown metric '{metric}'.")
