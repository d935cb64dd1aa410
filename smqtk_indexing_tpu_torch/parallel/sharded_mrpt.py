"""
Row-sharded MRPT query: per-shard leaf tables and the k-sized merge.

Counterpart of ``smqtk_indexing_tpu/parallel/sharded_mrpt.py``. The global
leaf permutation indexes arbitrary rows, so it is laid out anew at build
(:func:`shard_leaf_tables`, the JAX numpy code): each shard holds, for
every tree, the sub-permutation restricted to its contiguous row block,
in leaf order, with per-(shard, tree) leaf offsets. A query descends every
tree on every shard (the splits are replicated), gathers only its own
leaf segments from its own rows, scores them with ``ops/mrpt``'s
candidate top-k and exact finish (the gather route's arithmetic: the
mirror is single-device, as in JAX), and the per-shard (B, k) winners
merge (``sharded_scan._hier_merge``).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32
from smqtk_indexing_tpu_torch.ops.mrpt import (
    _candidate_topk, _finish, descend_leaves,
)
from smqtk_indexing_tpu_torch.parallel.mesh import Mesh, Shards, replicate
from smqtk_indexing_tpu_torch.parallel.sharded_scan import sharded_topk


def shard_leaf_tables(leaf_table: np.ndarray, offsets: np.ndarray,
                      n_shards: int, capacity: int
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
    """
    Lay the global leaf permutation out as per-shard local tables
    (``sharded_mrpt.py:52-91``).

    :param leaf_table: (T, N) int32 per-tree row permutations grouped by
        leaf (global row ids).
    :param offsets: (2^depth + 1,) shared global leaf boundaries.
    :param n_shards: Mesh size S; rows block-shard as
        ``[s * capacity/S, (s+1) * capacity/S)``.
    :param capacity: Padded device row capacity (divisible by n_shards).
    :return: (leaf_local (S, T, capacity // S) int32 local row ids in leaf
        order, zero past a shard's real rows; off_local (S, T, 2^depth + 1)
        int32 per-shard leaf boundaries; the largest per-shard leaf
        segment).
    """
    t_count, _ = leaf_table.shape
    if capacity % n_shards:
        raise ValueError(
            f"capacity {capacity} not divisible by {n_shards} shards.")
    blk = capacity // n_shards
    n_leaves = len(offsets) - 1
    leaf_ids = np.repeat(np.arange(n_leaves), np.diff(offsets))
    leaf_local = np.zeros((n_shards, t_count, blk), dtype=np.int32)
    off_local = np.zeros((n_shards, t_count, n_leaves + 1), dtype=np.int32)
    for t in range(t_count):
        perm = leaf_table[t].astype(np.int64)
        sid = perm // blk
        loc = (perm - sid * blk).astype(np.int32)
        # A stable shard-major grouping keeps leaf order within a shard.
        order = np.argsort(sid, kind="stable")
        counts = np.bincount(sid, minlength=n_shards)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for s in range(n_shards):
            seg = order[starts[s]:starts[s + 1]]
            leaf_local[s, t, :len(seg)] = loc[seg]
            off_local[s, t, 1:] = np.cumsum(
                np.bincount(leaf_ids[seg], minlength=n_leaves))
    leaf_max_local = int(np.diff(off_local, axis=-1).max())
    return leaf_local, off_local, leaf_max_local


def _local_query(db, db_sq, valid, leaf_l, off_l, bases, splits, q, *,
                 k: int, depth: int, leaf_max: int):
    """One shard's MRPT query (the ``shard_map`` body,
    ``sharded_mrpt.py:113-155``): per-tree local leaf offsets, the
    dedupe, the k + 16 candidate margin and the exact finish."""
    n_loc = db.shape[0]
    b = q.shape[0]
    t_count = bases.shape[0]
    q = q.float()
    q_sq = (q * q).sum(-1)
    require_full_f32(q)
    proj = torch.einsum("bd,tdl->btl", q, bases.float())
    leaves = descend_leaves(proj, splits, depth)              # (B, T)
    t_iota = torch.arange(t_count, device=q.device)[None, :]
    starts = off_l[t_iota, leaves].long()
    lengths = off_l[t_iota, leaves + 1].long() - starts
    ii = torch.arange(leaf_max, device=q.device)
    idx = torch.clamp(starts[..., None] + ii, 0, leaf_l.shape[1] - 1)
    ok = ii < lengths[..., None]
    t_idx = torch.arange(t_count, device=q.device)[None, :, None]
    m = t_count * leaf_max
    rows = leaf_l[t_idx, idx].long().reshape(b, m)
    ok = ok.reshape(b, m) & valid[rows]
    # A row lives on one shard, so the local dedupe is the global one.
    rows_sorted, _ = torch.sort(torch.where(ok, rows, n_loc), dim=1)
    dup = torch.zeros_like(ok)
    dup[:, 1:] = rows_sorted[:, 1:] == rows_sorted[:, :-1]
    alive = (rows_sorted < n_loc) & ~dup
    rows_u = torch.clamp(rows_sorted, 0, n_loc - 1)
    k_sel = min(k + 16, m)
    top_s, top_r = _candidate_topk(db, db_sq, q, rows_u, alive, k_sel)
    return _finish(db, q, q_sq, top_s, top_r, k)


def sharded_mrpt_query(mesh: Mesh, db: Shards, db_sq: Shards,
                       valid: Shards, bases, splits, leaf_local: Shards,
                       off_local: Shards, q, *, k: int, depth: int,
                       leaf_max: int):
    """
    Batched MRPT query over a row-sharded database.

    :param db, db_sq, valid: row-sharded; ``leaf_local`` / ``off_local``
        sharded on their leading S axis (a shard's block is (1, T, ...)).
    :param bases, splits, q: tensors or replicated.
    :param leaf_max: per-shard leaf segment bound (from
        :func:`shard_leaf_tables`, rounded up to a power of two by
        callers).
    :return: (dists (B, k) ascending with +inf padding, global rows (B, k)
        int64 with -1 padding) on the mesh's first device.
    """
    bases_s, splits_s, qs = (replicate(mesh, x) for x in (bases, splits, q))

    def local(s, kk):
        d, r = _local_query(
            db[s], db_sq[s], valid[s], leaf_local[s][0], off_local[s][0],
            bases_s[s], splits_s[s], qs[s], k=kk, depth=depth,
            leaf_max=leaf_max)
        return d, r, db[s].shape[0]
    return sharded_topk(mesh, k, local)
