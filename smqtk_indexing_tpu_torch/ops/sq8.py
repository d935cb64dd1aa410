"""
SQ8 scalar-quantized vector codec and the flat store's scan.

Counterpart of ``smqtk_indexing_tpu/ops/sq8.py:40-307`` (``sq8_train``,
``sq8_encode_np``, ``sq8_decode``, ``sq8_build_store``, ``sq8_row_stats``,
``sq8_topk``). Vectors are stored as one int8 code per dimension with
a per-dimension affine codec ``x_d ~= a_d * u_d + b_d``. The host-side
numpy functions are re-written here, not imported, because the JAX module
imports jax; they are the same arithmetic, so both packages train the same
codec and encode the same codes from the same rows.

The scan never dequantizes the database. With ``r = q - b`` and
``t = r * a``::

    ||q - x_hat||^2 = sum(r^2) - 2 <t, u> + sum(a^2 u^2)

so a kernel scores int8 codes against ``t`` plus a per-row
``s2 = sum(a^2 u^2)`` (``ops/ivf_scan.py``, and ``sq8_topk``'s stage 1
through the int8 form of K1, ``fused_scan.segment_minima``).

``sq8_topk_blocked`` (``sq8.py:310-429``) is the single-copy capacity scan:
stage 1 over the tiled layout through K5 (``segment_minima_tiled2``) or
over the blocked layout through K4 (``segment_minima_blocked``).

Both kernel routes take ``i8dot`` (``sq8.py:136-147, 253-257, 368-374``):
stage 1 runs int8 x int8, the query fold quantised to int8 with one
global scale g and the row stats divided by g (``_i8dot_q``), through the
int8-query forms of K1, K4 and K5. The minima come back divided by g, a
positive per-batch rescale that changes no ranking and keeps the +inf of
dead rows; stage 2 and the exact re-rank rescore from the unscaled fold.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32
from smqtk_indexing_tpu_torch.ops.fused_scan import (
    SEG, STAGE2_BYTES, seg_gather_tiled, segment_minima,
    segment_minima_blocked, segment_minima_tiled2, topk_segments_stepmajor,
    topk_smallest,
)
from smqtk_indexing_tpu_torch.ops.scan import (
    ELEMENTWISE_BYTES, codec_topk, exact_rerank_decoded, hik_scores,
)

SQ8_METRICS = ("euclidean", "inner_product", "cosine", "hik")

#: Rows per streamed block (divides every 1024 * 2^m capacity). A store
#: whose capacity is past one block, and a multiple of the TPU kernel's
#: 4096-row tile, runs stage 1 through K1 (``ops/store.py``).
DEFAULT_CHUNK = 65536


def sq8_train(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """
    Fit the per-dimension affine codec: ``a`` spans the observed range over
    the 254-step int8 grid, ``b`` centres it.

    :return: (a (d,) float32 scale, b (d,) float32 offset).
    """
    mn = mat.min(axis=0).astype(np.float64)
    mx = mat.max(axis=0).astype(np.float64)
    # Constant dimensions still decode exactly: a = 0 would divide by zero
    # in the encode, so it is floored at a tiny epsilon (codes become 0 and
    # b reproduces the constant).
    a = np.maximum((mx - mn) / 254.0, 1e-12)
    b = (mx + mn) / 2.0
    return a.astype(np.float32), b.astype(np.float32)


def sq8_encode_np(mat: np.ndarray, a: np.ndarray, b: np.ndarray
                  ) -> np.ndarray:
    """Quantize rows to int8 codes on the host (out-of-range rows clip)."""
    u = np.rint((mat.astype(np.float32) - b) / a)
    return np.clip(u, -127, 127).astype(np.int8)


def sq8_decode(codes: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Dequantize int8 codes to float32 rows."""
    return codes.float() * a + b


def sq8_row_stats(codes: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``s2 = sum((a u)^2)`` and the dequantized row L2 norm."""
    u = codes.float()
    s2 = ((a * u) ** 2).sum(-1)
    x = u * a + b
    return s2, torch.sqrt((x * x).sum(-1))


def sq8_build_store(host: np.ndarray, valid_mask: np.ndarray, capacity: int,
                    d_pad: int, dim: int, device,
                    codec: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """
    The one shared SQ8 row-major store build (``sq8.py:79-125``; the flat
    store and the IVF rows tier): the codec trained over the live rows (or
    ``codec``, the train-once contract), padding dims with scale 1e-12 and
    offset 0, so zero-padded codes and queries add nothing to any score
    term.

    :return: (a (d_pad,), b (d_pad,), codes (capacity, d_pad) int8,
        s2 (capacity,), nrm (capacity,)), tensors on ``device``.
    """
    n = host.shape[0]
    if codec is not None:
        a, b = codec
    else:
        live = host[valid_mask] if not valid_mask.all() else host
        a, b = sq8_train(live)
    a_p = np.full(d_pad, 1e-12, dtype=np.float32)
    b_p = np.zeros(d_pad, dtype=np.float32)
    a_p[:dim] = a
    b_p[:dim] = b
    codes = np.zeros((capacity, d_pad), dtype=np.int8)
    codes[:n, :dim] = sq8_encode_np(host, a, b)
    a_dev = torch.from_numpy(a_p).to(device)
    b_dev = torch.from_numpy(b_p).to(device)
    codes_dev = torch.from_numpy(codes).to(device)
    s2, nrm = sq8_row_stats(codes_dev, a_dev, b_dev)
    return a_dev, b_dev, codes_dev, s2, nrm


def _i8dot_q(t: torch.Tensor, sq_row: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The int8 x int8 stage 1's operands (``sq8.py:136-147``, bit for
    bit): the query fold quantised to int8 with ONE global scale
    ``g = max(max|t| / 127, 1e-30)`` across the batch (round half to even,
    clipped to +-127), and the stage-1 row stats divided by g. The
    kernels' integer products then rank as g * (sq / g - 2 <t_i8, u>), a
    positive rescale of the surrogate with ~2^-8 relative rounding, the
    order of the bf16 query's.

    :return: (t_i8 (B, d) int8, sq_row / g)."""
    g = torch.clamp(t.abs().max() / 127.0, min=1e-30)
    t_i8 = torch.clamp(torch.round(t / g), -127, 127).to(torch.int8)
    return t_i8, sq_row / g


def sq8_topk(codes: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
             s2: torch.Tensor, nrm: torch.Tensor, valid: torch.Tensor,
             q: torch.Tensor, *, k: int, metric: str = "euclidean",
             chunk: int = DEFAULT_CHUNK, fused: bool = False,
             i8dot: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Exhaustive top-k over an SQ8-coded database (``sq8.py:150-307``): the
    surrogate scores of the int8 codes against the query fold, a k + 8
    margin, and an exact re-rank of the winners from dequantized f32 rows,
    so distances are exact with respect to the quantized vectors.
    Selection runs in f32; the JAX package's streamed path ranks with bf16
    products (``sq8.py:127-133``).

    :param codes: (N, d) int8 codes (rows past the live set zero).
    :param a, b: (d,) float32 codec scale and offset.
    :param s2: (N,) float32 ``sum((a u)^2)``.
    :param nrm: (N,) float32 dequantized row norms.
    :param valid: (N,) bool row liveness.
    :param q: (B, d) float32 queries.
    :param fused: run stage 1 through K1's int8 form over the row-major
        codes (euclidean and inner_product, N > ``chunk``): the query fold
        rounds to bf16 there, as on the TPU; stage 2 rescores in f32.
    :param i8dot: with ``fused``, run that stage 1 int8 x int8
        (:func:`_i8dot_q`, K1's int8-query form); stage 2 is unchanged.
        Without ``fused`` it changes nothing, as in the JAX function,
        whose streamed stage 1 ignores it (``sq8.py:237-262``).
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    :raises ValueError: ``fused`` with another metric than euclidean or
        inner_product.
    """
    if metric not in SQ8_METRICS:
        raise ValueError(
            f"metric must be one of {SQ8_METRICS}, got {metric!r}")
    n, d = codes.shape
    q = q.float()
    q_norm = torch.sqrt((q * q).sum(-1))
    # inner_product / cosine: <q, x_hat> = <q a, u> + <q, b>.
    t = (q - b) * a if metric == "euclidean" else q * a
    qb = (q * b).sum(-1)

    def surrogate(ip, s2_sel, nrm_sel, q_b, q_n):
        if metric == "euclidean":
            return s2_sel - 2.0 * ip
        if metric == "inner_product":
            return -(ip + q_b)
        denom = q_n * nrm_sel
        return -((ip + q_b) / torch.where(denom == 0, 1.0, denom))

    def score_block(lo, hi):
        if metric == "hik":
            return hik_scores(q, sq8_decode(codes[lo:hi], a, b))
        require_full_f32(t)
        return surrogate(t @ codes[lo:hi].float().T, s2[None, lo:hi],
                         nrm[None, lo:hi], qb[:, None], q_norm[:, None])

    def score_rows(q0, q1, rows):
        cand = codes[rows]                               # (b, R, d)
        if metric == "hik":
            return 1.0 - torch.minimum(q[q0:q1, None, :],
                                       sq8_decode(cand, a, b)).sum(-1)
        ip = (cand.float() * t[q0:q1, None, :]).sum(-1)
        return surrogate(ip, s2[rows], nrm[rows], qb[q0:q1, None],
                         q_norm[q0:q1, None])

    minima = None
    if fused:
        if metric not in ("euclidean", "inner_product"):
            raise ValueError(
                "the fused SQ8 stage 1 serves euclidean / inner_product, "
                f"not {metric!r}")
        # Stage-1 values only rank segments, so inner_product's dropped
        # <q, b> (a per-query constant) changes no selection.
        penalty = torch.where(valid, 0.0, math.inf).to(torch.float32)
        sq_row = s2 if metric == "euclidean" else torch.zeros_like(s2)
        t_k = t
        if i8dot:
            # The minima come back divided by g: only their ranking is used.
            t_k, sq_row = _i8dot_q(t, sq_row)
        minima = segment_minima(codes, sq_row, penalty, t_k)
    block = chunk if metric != "hik" else \
        max(128, ELEMENTWISE_BYTES // (4 * max(q.shape[0], 1) * d)
            // 128 * 128)
    return codec_topk(score_block, score_rows,
                      lambda rows: sq8_decode(codes[rows], a, b), valid, q,
                      q_norm, n=n, k=k, metric=metric, chunk=chunk,
                      block=block, row_bytes=9 * d, minima=minima)


def blocked_select(codes_blk: torch.Tensor, sq_row: torch.Tensor,
                   penalty: torch.Tensor, t: torch.Tensor, s_keep: int,
                   i8dot: bool = False) -> torch.Tensor:
    """Stage 1 of :func:`sq8_topk_blocked` and its selection: (B, s_keep)
    ids of the segments with the smallest minima, -1 where the minimum is
    +inf. Tiled layout: K5 and ``topk_segments_stepmajor``; blocked layout:
    K4 and ``topk_smallest``. ``i8dot``: stage 1 int8 x int8
    (:func:`_i8dot_q`)."""
    nseg = codes_blk.shape[0] * codes_blk.shape[2] // SEG
    if i8dot:
        t, sq_row = _i8dot_q(t, sq_row)
    if codes_blk.shape[2] != SEG:
        m1, m2 = segment_minima_tiled2(codes_blk, sq_row, penalty, t)
        smin, sid = topk_segments_stepmajor(m1, m2, s_keep)
    else:
        minima = segment_minima_blocked(codes_blk, sq_row.view(nseg, SEG),
                                        penalty.view(nseg, SEG), t)
        smin, sid = topk_smallest(minima, s_keep)
    return torch.where(torch.isinf(smin), -1, sid)


def blocked_candidates(codes_blk: torch.Tensor,
                       sid: torch.Tensor) -> torch.Tensor:
    """The kept segments' codes as rows, (B, s_keep * 128, d) int8: (d, 128)
    column slices gathered by K3 (tiled layout) or whole contiguous blocks
    by indexing (blocked layout), then transposed to rows."""
    sid_c = torch.clamp(sid, min=0)
    if codes_blk.shape[2] != SEG:
        blk = seg_gather_tiled(codes_blk, sid_c)
    else:
        blk = codes_blk[sid_c]
    bq, s_keep, d, _ = blk.shape
    return blk.transpose(2, 3).reshape(bq, s_keep * SEG, d)


def blocked_rescore(cand: torch.Tensor, sid: torch.Tensor, s2: torch.Tensor,
                    valid: torch.Tensor, t: torch.Tensor, qb: torch.Tensor,
                    metric: str, kk: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 surrogate of every candidate row and its best ``kk``: (scores
    (B, kk) ascending, +inf for dead or empty; indices into the candidate
    rows). Runs in query blocks under ``STAGE2_BYTES``."""
    bq, m_rows, d = cand.shape
    nseg = s2.shape[0] // SEG
    sid_c = torch.clamp(sid, min=0)
    alive = ((sid[..., None] >= 0) & valid.view(nseg, SEG)[sid_c]) \
        .reshape(bq, m_rows)
    s2_seg = s2.view(nseg, SEG)
    q_block = max(1, STAGE2_BYTES // (4 * m_rows * d))
    best_s, sel = [], []
    for lo in range(0, bq, q_block):
        hi = min(lo + q_block, bq)
        ip = (cand[lo:hi].float() * t[lo:hi, None, :]).sum(-1)
        if metric == "inner_product":
            sc = -(ip + qb[lo:hi, None])
        else:
            sc = s2_seg[sid_c[lo:hi]].reshape(hi - lo, m_rows) - 2.0 * ip
        sv, si = topk_smallest(torch.where(alive[lo:hi], sc, math.inf), kk)
        best_s.append(sv)
        sel.append(si)
    return torch.cat(best_s), torch.cat(sel)


def sq8_topk_blocked(codes_blk: torch.Tensor, a: torch.Tensor,
                     b: torch.Tensor, s2: torch.Tensor, valid: torch.Tensor,
                     q: torch.Tensor, *, k: int, metric: str = "euclidean",
                     i8dot: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Exhaustive SQ8 top-k over one resident copy of the codes in a
    transposed layout (``sq8.py:310-429``): the capacity configuration,
    with no row-major copy and no mirror. The layout is told by the
    trailing dim:

    - (n_tiles, d, tile_n), tile_n != 128, **tiled**
      (``fused_scan.tiled_layout``): stage 1 is K5
      (``segment_minima_tiled2``) and ``topk_segments_stepmajor``; stage 2
      gathers (d, 128) column slices with K3 (``seg_gather_tiled``);
    - (N / 128, d, 128) **blocked** (``fused_scan.blocked_layout``): stage
      1 is K4 (``segment_minima_blocked``) and ``topk_smallest``; stage 2
      gathers whole contiguous blocks by indexing.

    Then the k + 16 kept segments' rows are rescored in f32 (the JAX
    function uses bf16 products there, ``:411-413``), and the best k + 8
    are decoded and re-ranked exactly (``scan.exact_rerank_decoded``), so
    distances are exact with respect to the quantized vectors.

    :param codes_blk: int8 codes in the tiled or the blocked layout.
    :param a, b: (d,) float32 codec scale and offset.
    :param s2: (N,) float32 ``sum((a u)^2)`` in row order.
    :param valid: (N,) bool row liveness in row order.
    :param q: (B, d) float32 queries.
    :param metric: 'euclidean' or 'inner_product' (the stage-1 surrogate
        form); ``sq8_topk`` serves the others.
    :param i8dot: run stage 1 int8 x int8 (:func:`_i8dot_q`, the
        int8-query forms of K5 and K4); the rescore is unchanged.
    :return: (dists (B, k) ascending, row ids (B, k) int64; +inf / -1
        pads).
    :raises ValueError: any other metric.
    """
    if metric not in ("euclidean", "inner_product"):
        raise ValueError(
            "sq8_topk_blocked serves euclidean/inner_product, not "
            f"{metric!r} (see sq8_topk for the other metrics).")
    nseg = codes_blk.shape[0] * codes_blk.shape[2] // SEG
    q = q.float()
    q_norm = torch.sqrt((q * q).sum(-1))
    t = (q - b) * a if metric == "euclidean" else q * a
    qb = (q * b).sum(-1)
    sq_row = s2 if metric == "euclidean" else torch.zeros_like(s2)
    # Built once per call: 4 bytes a row (0.4 GB at 100M rows).
    penalty = torch.where(valid, 0.0, math.inf).to(torch.float32)
    s_keep = min(k + 16, nseg)
    sid = blocked_select(codes_blk, sq_row, penalty, t, s_keep, i8dot)
    del penalty, sq_row
    cand = blocked_candidates(codes_blk, sid)
    kk = min(k + 8, cand.shape[1])
    best_s, sel = blocked_rescore(cand, sid, s2, valid, t, qb, metric, kk)
    rows = torch.clamp(sid, min=0)[..., None] * SEG \
        + torch.arange(SEG, device=q.device)
    best_r = torch.gather(rows.reshape(q.shape[0], -1), 1, sel)
    best_r = torch.where(torch.isinf(best_s), -1, best_r)
    x = torch.gather(cand, 1, sel[..., None].expand(-1, -1, cand.shape[2]))
    x = x.float() * a + b
    return exact_rerank_decoded(x, q, q_norm, best_s, best_r, metric, k)
