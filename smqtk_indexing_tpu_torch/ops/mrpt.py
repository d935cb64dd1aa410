"""
MRPT (Multiple Random Projection Trees): tree construction and the batched
query, on a torch device.

Port of ``smqtk_indexing_tpu/ops/mrpt.py`` (after Hyvönen et al.,
arXiv:1509.06957):

- ``project_all`` projects the database against every tree's basis in
  one full-f32 product a chunk of rows (TF32 would move the medians).
- ``build_trees`` is the JAX package's numpy construction, verbatim:
  balanced median splits stored as heap-order split arrays plus one row
  permutation a tree ("leaf table"). Splits sit at segment midpoints, so
  the leaf boundaries depend only on (N, depth) and are shared by every
  tree. Given the same projections it gives the same arrays bit for bit.
- ``mrpt_query`` descends every tree, gathers the union of the query's
  leaves, dedupes it by sort-and-mask, scores the candidates in chunks
  with a running top-k, and finishes with the exact L2 re-rank
  (``ops/scan._exact_selected``).
- ``mrpt_query_mirror`` scans per-tree leaf-ordered SQ8 copies instead:
  every (query, tree) leaf is a contiguous window of the mirror, scored
  by K6's int8 form (``ops/ivf_scan.ivf_list_scores``,
  ``csrc/ivf_list_scores.cu``); the winners dedupe by row and re-rank
  exactly from the f32 rows.

On a CUDA tensor K6 launches or raises; on a CPU tensor its plain version
runs. The rest is plain torch.
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32
from smqtk_indexing_tpu_torch.ops.fused_scan import topk_smallest
from smqtk_indexing_tpu_torch.ops.ivf_scan import (
    L_MAX, SCORE_BYTES, ivf_list_scores,
)
from smqtk_indexing_tpu_torch.ops.scan import _exact_selected

#: The JAX kernel's probes per grid step: the mirror's probe budget pads
#: to a multiple of it, so the selection widths are the JAX package's.
PROBES_PER_STEP = 128

#: Max f32 elements of one (B, chunk, d) candidate gather (~512 MB) before
#: candidate scoring streams in chunks instead of materializing (B, M, d).
_STREAM_ELEMS = 1 << 27


def project_all(db: torch.Tensor, bases: torch.Tensor,
                chunk: int = 65536) -> torch.Tensor:
    """(N, d) rows x (T, d, D) bases -> (N, T, D) f32 projections, in
    chunks of ``chunk`` rows (``ops/mrpt.py:37-51``)."""
    require_full_f32(db)
    n, d = db.shape
    t_count, _, depth = bases.shape
    flat = bases.float().permute(1, 0, 2).reshape(d, t_count * depth)
    out = torch.empty((n, t_count, depth), dtype=torch.float32,
                      device=db.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        out[lo:hi] = (db[lo:hi].float() @ flat).reshape(hi - lo, t_count,
                                                         depth)
    return out


def build_trees(projs: np.ndarray, depth: int
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """
    Host-side balanced median-split tree construction over precomputed
    projections (``ops/mrpt.py:54-100``).

    :param projs: (N, T, D) float32 projections (from :func:`project_all`).
    :param depth: Tree depth (leaves = 2^depth).
    :return: (splits (T, 2^depth - 1) float32 heap-order,
              leaf_table (T, N) int32 row permutations grouped by leaf,
              offsets (2^depth + 1,) int32 shared leaf boundaries).
    """
    n, t_count, d_depth = projs.shape
    if depth > d_depth:
        raise ValueError(f"depth {depth} > projection width {d_depth}")
    n_nodes = 2 ** depth - 1
    splits = np.zeros((t_count, n_nodes), dtype=np.float32)
    leaf_table = np.zeros((t_count, n), dtype=np.int32)

    # Shared segment boundaries: midpoint splits depend only on (N, depth).
    bounds = [(0, n)]
    level_bounds = [bounds]
    for _ in range(depth):
        nxt = []
        for lo, hi in level_bounds[-1]:
            mid = lo + (hi - lo) // 2
            nxt.extend([(lo, mid), (mid, hi)])
        level_bounds.append(nxt)
    offsets = np.array([lo for lo, _ in level_bounds[-1]] + [n],
                       dtype=np.int32)

    for t in range(t_count):
        order = np.arange(n, dtype=np.int32)
        node = 0
        for level in range(depth):
            for lo, hi in level_bounds[level]:
                seg = hi - lo
                if seg > 1:
                    vals = projs[order[lo:hi], t, level]
                    mid_off = seg // 2
                    part = np.argpartition(vals, mid_off)
                    order[lo:hi] = order[lo:hi][part]
                    splits[t, node] = vals[part[mid_off]]
                elif seg == 1:
                    splits[t, node] = projs[order[lo], t, level]
                node += 1
        leaf_table[t] = order
    return splits, leaf_table, offsets


def descend_leaves(proj: torch.Tensor, splits: torch.Tensor,
                   depth: int) -> torch.Tensor:
    """
    Descend every tree for every query (``ops/mrpt.py:193-213``).

    :param proj: (B, T, D) query projections.
    :param splits: (T, 2^depth - 1) split values (heap order).
    :return: (B, T) int64 leaf indices in [0, 2^depth).
    """
    b, t_count, _ = proj.shape
    t_idx = torch.arange(t_count, device=proj.device)[None, :]
    node = torch.zeros((b, t_count), dtype=torch.long, device=proj.device)
    for level in range(depth):
        right = (proj[..., level] >= splits[t_idx, node]).long()
        node = 2 * node + 1 + right
    return node - (2 ** depth - 1)


def _candidate_topk(db: torch.Tensor, db_sq: torch.Tensor, q: torch.Tensor,
                    rows_u: torch.Tensor, alive: torch.Tensor, k_inner: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    L2-surrogate top-k over per-query candidate rows
    (``ops/mrpt.py:108-190``).

    The JAX package scores a batch of at least 8 queries (a multiple of
    its 32-query cohort) in bf16 with f32 sums, and others in full f32.
    Here the same cases take the same arithmetic: the cohort's operands
    are rounded to bf16 and multiplied in f32, whose products of bf16
    values are exact; each query is scored against its own candidates
    only (the JAX cohort product's 31 other queries a block fed the TPU's
    matrix unit, and the candidate gather is read once either way).

    :param rows_u: (B, M) clipped candidate row ids.
    :param alive: (B, M) candidate liveness.
    :return: ((B, k_inner) ascending surrogate scores, (B, k_inner) rows).
        When B * M * d exceeds ``_STREAM_ELEMS`` the gather streams in
        power-of-two M-chunks with a running top-k merge.
    """
    b, m = rows_u.shape
    d = db.shape[1]
    cohort = min(32, b)
    bf16 = b >= 8 and b % cohort == 0
    qq = q.float()
    if bf16:
        qq = qq.to(torch.bfloat16).float()
    require_full_f32(qq)

    def score(rows_c, alive_c):
        cand = db[rows_c].float()                            # (B, mc, d)
        if bf16:
            cand = cand.to(torch.bfloat16).float()
        ip = torch.bmm(cand, qq[:, :, None])[..., 0]
        s = db_sq[rows_c] - 2.0 * ip
        return torch.where(alive_c, s, math.inf)

    if b * m * d <= _STREAM_ELEMS:
        s, sel = topk_smallest(score(rows_u, alive), k_inner)
        return s, torch.gather(rows_u, 1, sel)

    # Pad M to a power of two and stream chunk-wise.
    m_pad = 1
    while m_pad < m:
        m_pad *= 2
    if m_pad != m:
        rows_u = torch.cat([rows_u, rows_u.new_zeros((b, m_pad - m))], 1)
        alive = torch.cat([alive, alive.new_zeros((b, m_pad - m))], 1)
    mc = max(min(_STREAM_ELEMS // (b * d), m_pad), k_inner)
    mc_p = 1
    while mc_p * 2 <= mc:
        mc_p *= 2
    mc = mc_p
    best_s = torch.full((b, k_inner), math.inf, dtype=torch.float32,
                        device=db.device)
    best_r = rows_u.new_zeros((b, k_inner))
    for c0 in range(0, m_pad, mc):
        r_blk = rows_u[:, c0:c0 + mc]
        cand_s = torch.cat([best_s, score(r_blk, alive[:, c0:c0 + mc])], 1)
        cand_r = torch.cat([best_r, r_blk], 1)
        best_s, sel = topk_smallest(cand_s, k_inner)
        best_r = torch.gather(cand_r, 1, sel)
    return best_s, best_r


def _finish(db, q, q_sq, scores, rows, k: int):
    """Exact L2 of the selected rows, ascending, as (B, k) with +inf / -1
    past the selection (``ops/mrpt.py:273-282``)."""
    rows = torch.where(torch.isinf(scores), -1, rows)
    d_fin, r_fin = _exact_selected("euclidean", db, q, q_sq, scores, rows)
    b, kk = d_fin.shape
    if kk < k:
        d_fin = torch.cat([d_fin, d_fin.new_full((b, k - kk), math.inf)], 1)
        r_fin = torch.cat([r_fin, r_fin.new_full((b, k - kk), -1)], 1)
    return d_fin[:, :k], r_fin[:, :k]


def mrpt_query(db: torch.Tensor, db_sq: torch.Tensor, valid: torch.Tensor,
               bases: torch.Tensor, splits: torch.Tensor,
               leaf_table: torch.Tensor, offsets: torch.Tensor,
               q: torch.Tensor, *, k: int, depth: int, leaf_max: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Batched MRPT query (``ops/mrpt.py:215-283``): descend every tree,
    union the leaf candidates, dedupe, exact-L2 top-k.

    :param db: (N, d) database rows (original order).
    :param db_sq: (N,) squared norms.
    :param valid: (N,) liveness mask.
    :param bases: (T, d, D) projection bases.
    :param splits: (T, 2^depth - 1) split values (heap order).
    :param leaf_table: (T, N) per-tree row permutation grouped by leaf.
    :param offsets: (2^depth + 1,) shared leaf boundaries.
    :param q: (B, d) float32 queries.
    :return: (dists (B, k) ascending with +inf padding, rows (B, k) int64
        with -1 padding; no duplicate rows per query).
    """
    n = db.shape[0]
    b = q.shape[0]
    t_count = bases.shape[0]
    q = q.float()
    q_sq = (q * q).sum(-1)
    require_full_f32(q)
    proj = torch.einsum("bd,tdl->btl", q, bases)              # (B, T, D)
    leaves = descend_leaves(proj, splits, depth)              # (B, T)

    starts = offsets[leaves].long()
    lengths = offsets[leaves + 1].long() - starts
    ii = torch.arange(leaf_max, device=q.device)
    idx = torch.clamp(starts[..., None] + ii, 0, n - 1)       # (B, T, L)
    ok = ii < lengths[..., None]
    t_idx = torch.arange(t_count, device=q.device)[None, :, None]
    m = t_count * leaf_max
    rows = leaf_table[t_idx, idx].long().reshape(b, m)
    ok = ok.reshape(b, m) & valid[rows]

    # Dedupe across trees: sort rows (dead slots to sentinel n), mask
    # repeats so one physical row can't fill two result slots.
    rows_sorted, _ = torch.sort(torch.where(ok, rows, n), dim=1)
    dup = torch.zeros_like(ok)
    dup[:, 1:] = rows_sorted[:, 1:] == rows_sorted[:, :-1]
    alive = (rows_sorted < n) & ~dup
    rows_u = torch.clamp(rows_sorted, 0, n - 1)

    # k+16 row margin: the surrogate selection may run in bf16; the margin
    # plus the exact re-rank keep the reported top-k exact.
    k_sel = min(k + 16, m)
    top_s, top_r = _candidate_topk(db, db_sq, q, rows_u, alive, k_sel)
    return _finish(db, q, q_sq, top_s, top_r, k)


def mirror_windows(offsets: torch.Tensor, leaves: torch.Tensor,
                   cap: int, tn: int, leaf_max: int):
    """
    K6's windows over the leaf-ordered mirror (``ops/mrpt.py:329-352``):
    each (query, tree) leaf cut into sub-windows of ``L_MAX - 32`` rows
    (the slack absorbs the 32-row alignment of the start), the probe
    budget padded with dead slots to a multiple of ``PROBES_PER_STEP``.

    :param leaves: (B, T) leaf of each query in each tree.
    :param cap: Rows a tree takes in the mirror (tree t at
        ``[t * cap, t * cap + N)``).
    :param tn: Rows of the mirror (T * cap).
    :return: (starts, lo, hi), each (B, n_probe) int32: window start rows
        (``0 <= start <= tn - L_MAX``, a multiple of 32) and the local
        window ``[lo, hi)``; padding slots are ``lo == hi == 0``.
    """
    b, t_count = leaves.shape
    dev = leaves.device
    starts = offsets[leaves].long()
    lengths = offsets[leaves + 1].long() - starts
    sub_cap = L_MAX - 32
    n_sub = -(-leaf_max // sub_cap)
    jj = torch.arange(n_sub, device=dev)
    t_idx = torch.arange(t_count, device=dev)[None, :, None]
    g_start = t_idx * cap + starts[..., None] + jj * sub_cap
    ln = torch.clamp(lengths[..., None] - jj * sub_cap, 0, sub_cap)
    p_raw = t_count * n_sub
    pad = -(-p_raw // PROBES_PER_STEP) * PROBES_PER_STEP - p_raw
    g_start = torch.nn.functional.pad(g_start.reshape(b, p_raw), (0, pad))
    ln = torch.nn.functional.pad(ln.reshape(b, p_raw), (0, pad))
    c_start = torch.div(torch.clamp(g_start, max=tn - L_MAX), 32,
                        rounding_mode="floor") * 32
    lo = g_start - c_start
    return (c_start.to(torch.int32), lo.to(torch.int32),
            (lo + ln).to(torch.int32))


def mrpt_query_mirror(db: torch.Tensor, db_sq: torch.Tensor,
                      bases: torch.Tensor, splits: torch.Tensor,
                      mirror: torch.Tensor, mir_a: torch.Tensor,
                      mir_b: torch.Tensor, leaf_flat: torch.Tensor,
                      offsets: torch.Tensor, q: torch.Tensor, *, k: int,
                      depth: int, leaf_max: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    MRPT query over per-tree LEAF-ORDERED SQ8 mirrors
    (``ops/mrpt.py:285-401``): every (query, tree) candidate fetch is a
    contiguous window of the mirror, scored by K6's int8 form. The
    candidate set is :func:`mrpt_query`'s (the same leaves); the selection
    inside the union runs on the SQ8 scores with a k+8 margin a tree, then
    the winners re-rank exactly from the f32 rows, so reported distances
    are exact and selection noise is bounded by the codec at the rank-k
    boundary.

    K6's output is (B, P, L_MAX): flat score column ``s`` is window
    ``s // L_MAX``, lane ``s % L_MAX``. Queries run in blocks whose score
    block stays under ``ivf_scan.SCORE_BYTES`` (one block up to B = 1024
    at the usual 128 slots).

    :param mirror: (T * capacity, d) int8: tree t's SQ8 codes in leaf
        order at rows [t * capacity, t * capacity + n).
    :param mir_a, mir_b: (d,) SQ8 codec (padding dims epsilon / 0).
    :param leaf_flat: (T * capacity,) mirror row -> original row.
    :param offsets: (2^depth + 1,) shared leaf boundaries (rows in
        [0, n]).
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    """
    tn, _ = mirror.shape
    t_count = bases.shape[0]
    b = q.shape[0]
    q = q.float()
    q_sq = (q * q).sum(-1)
    require_full_f32(q)
    proj = torch.einsum("bd,tdl->btl", q, bases)
    leaves = descend_leaves(proj, splits, depth)              # (B, T)
    c_start, lo, hi = mirror_windows(offsets, leaves, tn // t_count, tn,
                                     leaf_max)
    n_probe = c_start.shape[1]
    t_q = (q - mir_b[None, :]) * mir_a[None, :]

    # One physical row appears in up to T trees with bitwise-equal scores,
    # so (k + 8) * T winners always hold k + 8 distinct rows.
    k_sel = min((k + 8) * t_count, n_probe * L_MAX)
    kk = min(k + 8, k_sel)
    q_block = max(1, SCORE_BYTES // (4 * n_probe * L_MAX))
    best_s, best_r = [], []
    for q0 in range(0, b, q_block):
        q1 = min(q0 + q_block, b)
        scores = ivf_list_scores(mirror, t_q[q0:q1], mir_a, c_start[q0:q1],
                                 lo[q0:q1], hi[q0:q1])
        sv, sel = topk_smallest(scores.reshape(q1 - q0, -1), k_sel)
        del scores
        mrows = torch.gather(c_start[q0:q1].long(), 1, sel // L_MAX) \
            + sel % L_MAX
        orig = leaf_flat[torch.clamp(mrows, 0, tn - 1)].long()
        orig = torch.where(torch.isinf(sv), -1, orig)
        # Dedupe across trees among the winners (sort by id; duplicate
        # scores are bitwise equal, so masking any repeat is safe).
        ids_s, order = torch.sort(torch.where(orig < 0, tn, orig), dim=1,
                                  stable=True)
        sc_s = torch.gather(sv, 1, order)
        dup = torch.zeros_like(sc_s, dtype=torch.bool)
        dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
        sc_s = torch.where(dup | (ids_s >= tn), math.inf, sc_s)
        s2, sel2 = topk_smallest(sc_s, kk)
        best_s.append(s2)
        best_r.append(torch.gather(ids_s, 1, sel2))
    return _finish(db, q, q_sq, torch.cat(best_s), torch.cat(best_r), k)
