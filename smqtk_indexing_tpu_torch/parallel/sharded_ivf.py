"""
Row-sharded IVF query (the rows tier).

Counterpart of ``smqtk_indexing_tpu/parallel/sharded_ivf.py``. The
list-sorted database row-shards contiguously; a shard's inverted-list view
is the clipped intersection of the global sublist ranges with its row span
(:func:`shard_csr`), so every shard runs the port's single-device list
gather (``ops/ivf.ivf_query`` / ``ivf_query_pq``) against the replicated
centroids and its local offsets and lengths. Each shard probes its own
``nprobe`` best non-empty sublists (a list cut by a shard boundary is
probed by both owners); results merge with the k-sized merge. K6 is
single-device, as in JAX (``ivf.py:298``).

With nprobe == n_lists this is exhaustive and exact. With
``first_virt`` / ``nprobe_orig`` (FAISS-faithful nprobe) every shard scans
its clipped part of exactly the ``nprobe_orig`` nearest original lists,
so the shard union is the single-device candidate set.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from smqtk_indexing_tpu_torch.ops.ivf import ivf_query, ivf_query_pq
from smqtk_indexing_tpu_torch.parallel.mesh import Mesh, Shards, replicate
from smqtk_indexing_tpu_torch.parallel.sharded_scan import sharded_topk


def shard_csr(offsets: np.ndarray, lens: np.ndarray, n_rows: int,
              n_shards: int) -> Tuple[np.ndarray, np.ndarray]:
    """
    Clip global CSR (offsets, lens) into per-shard local views
    (``sharded_ivf.py:33-57``).

    :param offsets: (C,) global list start rows.
    :param lens: (C,) global list lengths.
    :param n_rows: Total (padded) row count; must divide by n_shards.
    :return: (local_offsets (S, C) int32, relative to each shard's base,
        and local_lens (S, C) int32).
    """
    per = n_rows // n_shards
    out_off = np.zeros((n_shards, len(offsets)), dtype=np.int32)
    out_len = np.zeros((n_shards, len(offsets)), dtype=np.int32)
    starts = np.asarray(offsets, np.int64)
    ends = starts + np.asarray(lens, np.int64)
    for s in range(n_shards):
        lo, hi = s * per, (s + 1) * per
        c_start = np.clip(starts, lo, hi)
        c_end = np.clip(ends, lo, hi)
        out_off[s] = (c_start - lo).astype(np.int32)
        out_len[s] = (c_end - c_start).astype(np.int32)
    return out_off, out_len


def sharded_ivf_query(mesh: Mesh, db: Shards, db_sq: Shards,
                      db_norm: Shards, valid: Shards, centroids,
                      offsets: Shards, lens: Shards, q, *, k: int,
                      nprobe: int, l_max: int, metric: str = "euclidean",
                      dq=None, first_virt=None, nprobe_orig=None,
                      has_dead: bool = True):
    """
    :param db, db_sq, db_norm, valid: row-sharded (list-sorted order).
    :param centroids: (V, d) sublist centroids, a tensor or replicated.
    :param offsets, lens: per-shard local CSR views (``shard_rows`` of
        :func:`shard_csr`'s outputs; a shard's block is (1, V)).
    :param q: (B, d) queries, a tensor or replicated.
    :param dq: optional (a, b) SQ8 codec (int8 ``db``).
    :param first_virt, nprobe_orig: FAISS-faithful nprobe
        (``ops/ivf.probe_eligibility``).
    :return: (dists (B, k), global rows (B, k)) on the mesh's first
        device.
    """
    c_s, qs = replicate(mesh, centroids), replicate(mesh, q)
    fv_s = replicate(mesh, first_virt) if first_virt is not None else None
    dq_s = [replicate(mesh, t) for t in dq] if dq is not None else None

    def local(s, kk):
        n_loc = db[s].shape[0]
        d, r = ivf_query(
            db[s], db_sq[s], db_norm[s], valid[s], c_s[s], offsets[s][0],
            lens[s][0], qs[s], k=min(kk, n_loc), nprobe=nprobe,
            l_max=l_max, metric=metric,
            dq=None if dq_s is None else (dq_s[0][s], dq_s[1][s]),
            first_virt=None if fv_s is None else fv_s[s],
            nprobe_orig=nprobe_orig, has_dead=has_dead)
        return d, r, n_loc
    return sharded_topk(mesh, k, local)


def sharded_ivf_query_pq(mesh: Mesh, codes: Shards, codebooks, s2: Shards,
                         valid: Shards, centroids, offsets: Shards,
                         lens: Shards, q, *, k: int, nprobe: int,
                         l_max: int, metric: str = "euclidean",
                         first_virt=None, nprobe_orig=None,
                         has_dead: bool = True, res_cents=None,
                         row2list: Shards = None):
    """
    Row-sharded IVF over PQ codes (``ops/ivf.ivf_query_pq`` a shard, the
    layout of :func:`sharded_ivf_query`; codebooks, centroids and
    codec-grid queries replicated). Residual mode: ``res_cents``
    replicated, ``row2list`` row-sharded with the codes.
    """
    cb_s, c_s, qs = (replicate(mesh, x) for x in (codebooks, centroids, q))
    fv_s = replicate(mesh, first_virt) if first_virt is not None else None
    rc_s = replicate(mesh, res_cents) if res_cents is not None else None

    def local(s, kk):
        n_loc = codes[s].shape[0]
        d, r = ivf_query_pq(
            codes[s], cb_s[s], s2[s], valid[s], c_s[s], offsets[s][0],
            lens[s][0], qs[s], k=min(kk, n_loc), nprobe=nprobe,
            l_max=l_max, metric=metric,
            first_virt=None if fv_s is None else fv_s[s],
            nprobe_orig=nprobe_orig, has_dead=has_dead,
            res_cents=None if rc_s is None else rc_s[s],
            row2list=None if row2list is None else row2list[s])
        return d, r, n_loc
    return sharded_topk(mesh, k, local)
