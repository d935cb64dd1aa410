"""
Row-sharded tiled IVF serving: the code tier (``storage='code'``) over a
mesh.

Counterpart of ``smqtk_indexing_tpu/parallel/sharded_ivf_code.py``. The
code tier keeps its codes in the (n_tiles, d, TILE_ROWS) tiled-transposed
layout; this module shards that layout on the tile axis. Each shard owns a
contiguous, tile-aligned row range and holds its own sublist CSR and
list -> sublist slot table (global list spans clipped at shard
boundaries, :func:`shard_tiled_layout`), and runs the port's single-device
tiled query on its own tensors: K7 (``ops/ivf_scan.
ivf_query_dma_tiled_table``) for SQ8, K8 (``ivf_query_dma_tiled_table_pq``)
for PQ, each with K3 under ``rerank="gather"`` (the index's
``rerank="exact"``). A CUDA shard launches the kernels, a CPU shard runs
their plain versions: the choice follows each shard's device. Winners
merge with the k-sized merge.

Probe selection ranks the original centroids on every shard, and every
shard scans its clipped part of exactly the ``nprobe_orig`` nearest lists,
so the shard union is the single-device candidate set; a shard that owns
none of a query's lists still scans its (dead) slots.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from smqtk_indexing_tpu_torch.ops.ivf_scan import (
    TILE_ROWS, build_slot_table, build_tiled_csr, ivf_query_dma_tiled_table,
    ivf_query_dma_tiled_table_pq,
)
from smqtk_indexing_tpu_torch.parallel.mesh import Mesh, Shards, replicate
from smqtk_indexing_tpu_torch.parallel.sharded_scan import sharded_topk


def shard_tiled_layout(lens: np.ndarray, n_rows_pad: int, n_shards: int,
                       c_lists: int):
    """
    Clip the global list-sorted row layout at tile-aligned shard
    boundaries and build each shard's local tiled CSR and slot table,
    padded to common shapes (``sharded_ivf_code.py:41-93``).

    :param lens: (C,) per-list global row counts (list ``li`` occupies
        global rows ``[cumsum(lens)[li-1], + lens[li])``).
    :param n_rows_pad: total padded rows; ``n_rows_pad / n_shards`` must be
        a multiple of TILE_ROWS (a window never crosses a tile, and the
        tile axis is the sharded one).
    :param c_lists: original list count C.
    :return: (v_tile (S, V), v_col (S, V), v_len (S, V) int32, padded
        slots of length 0, and slot_table (S, C, S_max) int32, -1 padded).
    """
    per = n_rows_pad // n_shards
    if per % TILE_ROWS:
        raise ValueError(
            f"Shard row span {per} is not a multiple of TILE_ROWS "
            f"({TILE_ROWS}); pad n_rows to n_shards*TILE_ROWS multiples.")
    starts = np.concatenate([[0], np.cumsum(lens)[:-1]]).astype(np.int64)
    ends = starts + np.asarray(lens, np.int64)
    parts = []
    for s in range(n_shards):
        lo, hi = s * per, (s + 1) * per
        loc_lens = (np.clip(ends, lo, hi)
                    - np.clip(starts, lo, hi)).astype(np.int64)
        v_tile, v_col, v_len, v_orig, _ = build_tiled_csr(
            loc_lens[None, :], np.zeros(1, dtype=np.int64))
        parts.append((v_tile, v_col, v_len,
                      build_slot_table(v_orig, c_lists)))
    v_max = max(p[0].shape[0] for p in parts)
    s_max = max(p[3].shape[1] for p in parts)
    vt = np.zeros((n_shards, v_max), dtype=np.int32)
    vc = np.zeros((n_shards, v_max), dtype=np.int32)
    vl = np.zeros((n_shards, v_max), dtype=np.int32)
    st = np.full((n_shards, c_lists, s_max), -1, dtype=np.int32)
    for s, (t, c, ln, tab) in enumerate(parts):
        vt[s, :t.size] = t
        vc[s, :c.size] = c
        vl[s, :ln.size] = ln
        st[s, :, :tab.shape[1]] = tab
    return vt, vc, vl, st


def sharded_ivf_query_tiled(mesh: Mesh, db3: Shards, s2t: Shards, a,
                            b_codec, centroids, slot_table: Shards,
                            v_tile: Shards, v_col: Shards, v_len: Shards,
                            q, *, k: int, nprobe_orig: int,
                            rerank: str = "gather",
                            metric: str = "euclidean"
                            ) -> Tuple:
    """
    Sharded tiled IVF-SQ8 query (K7 a shard; K3 under ``rerank="gather"``).

    :param db3, s2t: (n_tiles, d, TILE_ROWS) codes and (n_tiles, 1,
        TILE_ROWS) row stats, sharded on the tile axis.
    :param a, b_codec, centroids, q: tensors or replicated.
    :param slot_table, v_tile, v_col, v_len: :func:`shard_tiled_layout`'s
        outputs, sharded on their leading axis.
    :return: (dists (B, k), global rows (B, k)) on the mesh's first
        device.
    """
    a_s, b_s, c_s, qs = (replicate(mesh, x)
                         for x in (a, b_codec, centroids, q))

    def local(s, kk):
        n_local = db3[s].shape[0] * db3[s].shape[2]
        d, r = ivf_query_dma_tiled_table(
            db3[s], s2t[s], a_s[s], b_s[s], c_s[s], slot_table[s][0],
            v_tile[s][0], v_col[s][0], v_len[s][0], qs[s],
            k=min(kk, n_local), nprobe_orig=nprobe_orig, rerank=rerank,
            metric=metric)
        return d, r, n_local
    return sharded_topk(mesh, k, local)


def sharded_ivf_query_tiled_pq(mesh: Mesh, db3c: Shards, s2t: Shards,
                               codebooks, perm, centroids,
                               slot_table: Shards, v_tile: Shards,
                               v_col: Shards, v_len: Shards, q, *, k: int,
                               nprobe_orig: int, rerank: str = "gather",
                               res_cents=None, row2list: Shards = None,
                               metric: str = "euclidean") -> Tuple:
    """
    Sharded tiled IVF-PQ query (K8 a shard; K3 under ``rerank="gather"``),
    raw, OPQ, or residual when ``res_cents`` / ``row2list`` are given: the
    per-probe ``-2 <q, c>`` offsets come from each shard's own probe
    selection over the replicated centroids, and the row -> list map is
    row-aligned, so it shards with the tiles (``res_cents`` replicated).
    """
    cb_s, pm_s, c_s, qs = (replicate(mesh, x)
                           for x in (codebooks, perm, centroids, q))
    rc_s = replicate(mesh, res_cents) if res_cents is not None else None

    def local(s, kk):
        n_local = db3c[s].shape[0] * db3c[s].shape[2]
        d, r = ivf_query_dma_tiled_table_pq(
            db3c[s], s2t[s], cb_s[s], pm_s[s], c_s[s], slot_table[s][0],
            v_tile[s][0], v_col[s][0], v_len[s][0], qs[s],
            k=min(kk, n_local), nprobe_orig=nprobe_orig, rerank=rerank,
            res_cents=None if rc_s is None else rc_s[s],
            row2list=None if row2list is None else row2list[s],
            metric=metric)
        return d, r, n_local
    return sharded_topk(mesh, k, local)
