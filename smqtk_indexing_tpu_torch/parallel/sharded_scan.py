"""
Row-sharded scans: the single-device top-k on each shard, then a k-sized
merge.

Counterpart of ``smqtk_indexing_tpu/parallel/sharded_scan.py``. Each
shard runs the port's single-device function (``ops/scan.flat_topk``,
``ops/hamming.hamming_topk``, ``ops/sq8.sq8_topk``, ``ops/pq.pq_topk``,
the re-rank's ``ops/metrics.candidate_distances``) on its own tensors,
offsets its local rows by ``shard * rows_per_shard``, and its (B, k)
result moves to the first device of its slice. Each slice merges there;
on a 2-D mesh the slices' (B, k) results then move to the mesh's first
device and merge again (``_hier_merge``, the JAX merge over "shard", then
over "dcn"). Every shard's work is issued before any result is read on
the host, so shards on different cards overlap.

The merge keeps the JAX tie order: ``jax.lax.top_k`` over the (B, S * k)
block laid out shard by shard gives ties to the lowest position, that is
the lowest shard first; the port takes a stable sort of that block
(``torch.topk`` does not promise an order among ties).

``sharded_kmeans_step`` is one data-parallel Lloyd step: per-shard
partial sums and counts in int64 fixed point (``kmeans.cell_sums``),
added exactly on the first device (the JAX ``psum``), so the result
depends neither on which shard finishes first nor on the shard count.
"""
from __future__ import annotations

import math
from typing import Callable, List, Tuple

import torch

from smqtk_indexing_tpu_torch.ops import hamming, scan
from smqtk_indexing_tpu_torch.ops.kmeans import (
    ASSIGN_CHUNK, _assign_block, cell_means, cell_sums, fixed_point_scale,
    to_fixed,
)
from smqtk_indexing_tpu_torch.ops.metrics import candidate_distances
from smqtk_indexing_tpu_torch.ops.pq import pq_topk
from smqtk_indexing_tpu_torch.ops.sq8 import sq8_topk
from smqtk_indexing_tpu_torch.parallel.mesh import (
    DCN_AXIS, SHARD_AXIS, Mesh, Shards, replicate,
)


def _merge_topk(d_all: torch.Tensor, r_all: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(S, B, k) per-shard results -> (B, k) merge, ascending; ties go to
    the lowest shard, then the lowest slot (a stable sort)."""
    s, b, kk = d_all.shape
    d_flat = d_all.permute(1, 0, 2).reshape(b, s * kk)
    r_flat = r_all.permute(1, 0, 2).reshape(b, s * kk)
    d_sorted, sel = torch.sort(d_flat, dim=1, stable=True)
    return d_sorted[:, :k], torch.gather(r_flat, 1, sel[:, :k])


def _global_shard_index(mesh: Mesh, dcn_index: int, shard_index: int
                        ) -> int:
    """Global shard index: slice-major on 2-D meshes, matching
    ``shard_rows``' row layout."""
    if DCN_AXIS in mesh.axis_names:
        return dcn_index * mesh.shape[SHARD_AXIS] + shard_index
    return shard_index


def _hier_merge(mesh: Mesh, results: List[Tuple[torch.Tensor,
                                                torch.Tensor]], k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Merge per-shard (B, k) results, listed in global shard order: within
    each slice on the slice's first device, then, on a 2-D mesh, across
    slices on the mesh's first device.

    :return: (dists (B, k), rows (B, k)) on ``mesh.first``.
    """
    devs = mesh.flat
    per_slice = []
    for members in mesh.slices():
        home = devs[members[0]]
        d_all = torch.stack([results[s][0].to(home) for s in members])
        r_all = torch.stack([results[s][1].to(home) for s in members])
        per_slice.append(_merge_topk(d_all, r_all, k))
    if DCN_AXIS not in mesh.axis_names:
        d, r = per_slice[0]
        return d.to(mesh.first), r.to(mesh.first)
    return _merge_topk(
        torch.stack([d.to(mesh.first) for d, _ in per_slice]),
        torch.stack([r.to(mesh.first) for _, r in per_slice]), k)


def sharded_topk(mesh: Mesh, k: int,
                 local: Callable[[int, int], Tuple[torch.Tensor,
                                                   torch.Tensor, int]]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    The shard_map body every sharded top-k shares: ``local(s, k_cap)``
    runs shard ``s``'s single-device search with at most ``k_cap``
    results and returns (dists, local rows, the shard's row count); the
    result is padded to k with +inf / -1, its rows offset by the global
    shard index times ``n_local``, and all shards merged
    (:func:`_hier_merge`). Every shard's work is issued before any
    result is read.
    """
    results = []
    for dcn_index, members in enumerate(mesh.slices()):
        for shard_index, s in enumerate(members):
            d, r, n_local = local(s, k)
            d, r = scan.pad_to_k(d, r, k)
            offset = _global_shard_index(mesh, dcn_index, shard_index) \
                * n_local
            results.append((d, torch.where(r >= 0, r + offset, r)))
    return _hier_merge(mesh, results, k)


def sharded_flat_topk(mesh: Mesh, db: Shards, db_sq: Shards,
                      db_norm: Shards, valid: Shards, q, *, k: int,
                      metric: str = "euclidean"):
    """
    Exhaustive top-k over a row-sharded database (``scan.flat_topk`` a
    shard).

    :param db, db_sq, db_norm, valid: row-sharded (``shard_rows``).
    :param q: (B, d) queries, a tensor or replicated.
    :return: (dists (B, k) ascending, global rows (B, k) int64) on the
        mesh's first device; +inf / -1 past the live rows.
    """
    qs = replicate(mesh, q)

    def local(s, kk):
        n_loc = db[s].shape[0]
        d, r = scan.flat_topk(db[s], db_sq[s], db_norm[s], valid[s], qs[s],
                              k=min(kk, n_loc), metric=metric)
        return d, r, n_loc
    return sharded_topk(mesh, k, local)


def sharded_hamming_topk(mesh: Mesh, db: Shards, valid: Shards, q, *,
                         k: int):
    """Row-sharded packed-code Hamming top-k (``hamming.hamming_topk`` a
    shard). The merge runs in float32 (exact for these integers), as in
    JAX; slots past the live codes hold ``hamming.INVALID`` (2**30) / -1.

    :return: (dists (B, k) int32, global rows (B, k) int32)."""
    qs = replicate(mesh, q)

    def local(s, kk):
        n_loc = db[s].shape[0]
        d, r = hamming.hamming_topk(db[s], valid[s], qs[s],
                                    k=min(kk, n_loc))
        return d.float(), r, n_loc
    d, r = sharded_topk(mesh, k, local)
    return torch.clamp(d, max=float(hamming.INVALID)).int(), r.int()


def sharded_sq8_topk(mesh: Mesh, codes: Shards, a, b, s2: Shards,
                     nrm: Shards, valid: Shards, q, *, k: int,
                     metric: str = "euclidean"):
    """Row-sharded SQ8 scan (``sq8.sq8_topk`` a shard, its streamed
    stage 1, as the JAX sharded store takes it). a / b / q: tensors or
    replicated."""
    a_s, b_s, qs = (replicate(mesh, x) for x in (a, b, q))

    def local(s, kk):
        n_loc = codes[s].shape[0]
        d, r = sq8_topk(codes[s], a_s[s], b_s[s], s2[s], nrm[s], valid[s],
                        qs[s], k=min(kk, n_loc), metric=metric)
        return d, r, n_loc
    return sharded_topk(mesh, k, local)


def sharded_pq_topk(mesh: Mesh, codes: Shards, codebooks, s2: Shards,
                    valid: Shards, q, *, k: int, metric: str = "euclidean"):
    """Row-sharded PQ scan (``pq.pq_topk`` a shard). codebooks / q
    (codec-grid queries): tensors or replicated."""
    cb_s, qs = replicate(mesh, codebooks), replicate(mesh, q)

    def local(s, kk):
        n_loc = codes[s].shape[0]
        d, r = pq_topk(codes[s], cb_s[s], s2[s], valid[s], qs[s],
                       k=min(kk, n_loc), metric=metric)
        return d, r, n_loc
    return sharded_topk(mesh, k, local)


def sharded_rerank_topk(mesh: Mesh, q, cand: Shards, valid: Shards, *,
                        k: int, metric: str = "euclidean"):
    """
    Candidate-sharded exact re-rank (the LSH composite): the (B, M, d)
    candidate block splits on its M axis (``shard_rows(mesh, cand,
    axis=1)``), each shard scores its slice with
    ``metrics.candidate_distances`` (the single-device re-rank's math, so
    distances are bit-identical), and the per-shard (B, k) winners merge.

    :return: (dists (B, k) ascending with +inf padding, positions (B, k)
        int64 into the global M axis with -1 padding).
    """
    qs = replicate(mesh, q)

    def local(s, kk):
        m_loc = cand[s].shape[1]
        d = candidate_distances(qs[s], cand[s], metric)
        d = torch.where(valid[s], d, math.inf)
        # Lowest position first among ties, as jax.lax.top_k.
        dd, sel = torch.sort(d, dim=1, stable=True)
        k_loc = min(kk, m_loc)
        dd, sel = dd[:, :k_loc], sel[:, :k_loc]
        sel = torch.where(torch.isinf(dd), -1, sel)
        return dd, sel, m_loc
    return sharded_topk(mesh, k, local)


def sharded_kmeans_step(mesh: Mesh, db: Shards, valid: Shards, centroids):
    """
    One data-parallel Lloyd step: each shard assigns its rows to the
    centroids (``kmeans._assign_block`` in ``ASSIGN_CHUNK`` blocks) and
    forms partial sums and counts in int64 fixed point under one scale
    for all shards (``kmeans.cell_sums``); the partials are added on the
    first device, exactly, and empty cells keep their centroid. The
    result does not depend on the shard count.

    :param centroids: (C, d), a tensor or replicated.
    :return: (new centroids (C, d) float32 on ``mesh.first``, per-shard
        assignments (row-sharded, int64)).
    """
    cs = replicate(mesh, centroids)
    amax = torch.stack([
        torch.where(valid[s].bool()[:, None], db[s].float().abs(), 0.0)
        .amax(0).to(mesh.first) if db[s].shape[0]
        else torch.zeros(db[s].shape[1], device=mesh.first)
        for s in range(mesh.size)]).amax(0)
    n_rows = sum(int(db[s].shape[0]) for s in range(mesh.size))
    scale = fixed_point_scale(amax, n_rows)
    partials, assigns = [], []
    for s in range(mesh.size):
        c = cs[s].float()
        c_count = c.shape[0]
        c_sq = (c * c).sum(-1)
        x = db[s].float()
        ok = valid[s].bool()
        sc = scale.to(x.device)
        sums = torch.zeros(c.shape, dtype=torch.int64, device=c.device)
        counts = torch.zeros(c_count, dtype=torch.int64, device=c.device)
        blocks = []
        for lo in range(0, max(x.shape[0], 1), ASSIGN_CHUNK):
            xb = x[lo:lo + ASSIGN_CHUNK]
            a = _assign_block(xb, c, c_sq)
            s_b, n_b = cell_sums(
                torch.where(ok[lo:lo + ASSIGN_CHUNK], a, c_count),
                to_fixed(xb, sc), c_count)
            sums += s_b
            counts += n_b
            blocks.append(a)
        partials.append((sums, counts))
        assigns.append(torch.cat(blocks))
    sums = sum(p_sum.to(mesh.first) for p_sum, _ in partials)
    counts = sum(p_count.to(mesh.first) for _, p_count in partials)
    new_c = cell_means(sums, counts, scale, cs[0].float().to(mesh.first))
    return new_c, assigns
