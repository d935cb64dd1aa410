"""
Exhaustive kNN scan with a carried running top-k, in plain PyTorch.

Counterpart of ``smqtk_indexing_tpu/ops/scan.py:26-144, 218-291``
(``METRICS``, ``_chunk_scores``, ``_finalize``, ``flat_topk``,
``pad_to_k``, ``_exact_selected``, ``rerank_exact``). Row blocks stream
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
                    rows: torch.Tensor):
    """
    True distances for the selected (B, k) rows, re-sorted ascending. For
    L2 the surrogate ``x_sq - 2ip`` cancels catastrophically at tiny
    distances, so the k winners are recomputed in the difference form from
    a (B, k, d) gather. Other metrics' surrogates finalise without
    cancellation. Slots past the live rows are +inf / -1 for every metric.
    """
    if metric != "euclidean":
        # Unfilled slots stay +inf (cosine would map them to 2).
        return torch.where(torch.isinf(scores), math.inf,
                           _finalize(metric, scores, q_sq)), rows
    sel = db[torch.clamp(rows, min=0)].float()
    # In place: the gather is a fresh copy.
    diff2 = sel.sub_(q[:, None, :]).square_()
    exact = torch.sqrt(torch.clamp(diff2.sum(-1), min=0.0))
    # Rows never filled (index -1 / +inf surrogate) stay +inf.
    exact = torch.where(torch.isinf(scores), math.inf, exact)
    # Exact values may reorder near-ties relative to the surrogate ranking.
    exact, order = torch.sort(exact, dim=1)
    return exact, torch.gather(rows, 1, order)


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
