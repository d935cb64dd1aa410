"""
Tiled (code-tier) engine of the port's ``IvfNearestNeighborsIndex``:
``smqtk_indexing_tpu/models/nn_index/_ivf_code.py`` (``encode_rows``
:19-54, ``upload_tiled`` single-device :57-187 and :243-261,
``query_tiled`` :264-349; the mesh branches :86-92, :191-241 and
:271-311).

It serves ``storage='code'`` always, and the rows tier's routed cells
(``ivf._tiled_rows_ok``: SQ8 with ``rerank='score'``, euclidean PQ). The
host builds the tiled-transposed layout and the per-row stats with the JAX
package's numpy arithmetic (float64 for the PQ stats), so both packages
hold the same tiles, stats and sublist tables for the same codes; the
device then holds them as tensors. SQ8 tiles are int8 (n_tiles, d_pad,
TILE_ROWS) and run K7; PQ tiles are uint8 (n_tiles, M, TILE_ROWS) and run
K8. Functions take the index instance as ``idx`` and run under its lock.

Under a mesh (``idx._make_mesh()``) the tile count rounds up to a multiple
of the shard count, the tiles and stats go from host memory straight to
each shard's device (sharded on the tile axis), each shard gets its
clipped sublist CSR and slot table (``parallel.sharded_ivf_code.
shard_tiled_layout``), the codec and centroids are replicated once, and
queries run ``sharded_ivf_query_tiled[_pq]``: K7 or K8 (and K3) a shard.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.ivf_scan import (
    TILE_ROWS, build_slot_table, build_tiled_csr, ivf_query_dma_tiled_table,
    ivf_query_dma_tiled_table_pq,
)
from smqtk_indexing_tpu_torch.ops.opq import compose_transform, opq_train
from smqtk_indexing_tpu_torch.ops.pq import pq_encode_np, pq_train
from smqtk_indexing_tpu_torch.ops.sq8 import sq8_encode_np, sq8_train
from smqtk_indexing_tpu_torch.parallel.mesh import replicate, shard_rows
from smqtk_indexing_tpu_torch.parallel.sharded_ivf_code import (
    shard_tiled_layout, sharded_ivf_query_tiled, sharded_ivf_query_tiled_pq,
)


def encode_rows(idx, mat: np.ndarray, assigns: np.ndarray,
                valid: np.ndarray) -> np.ndarray:
    """Code-tier host mirror: float32 rows train the codec once (the first
    build) and encode to int8 SQ8 or uint8 PQ codes; rows that are codes
    already (a re-layout after an update or a compaction) pass through.
    Cosine codes carry the unit rows; residual PQ codes carry
    ``x_T - c_T[list]``."""
    if idx._pq_m(idx.dtype) is not None:
        if mat.dtype == np.uint8:
            return mat
        m = idx._pq_m(idx.dtype)
        rows_c = idx._pq_prep_rows(idx._prep_for_metric(mat), rotate=False)
        if idx.pq_residual:
            rows_c = rows_c - idx._pq_cents_codec(None)[assigns]
        if idx._code_cb is None:
            live = rows_c[valid] if not valid.all() else rows_c
            if idx._pq_rotate(idx.dtype):
                idx._code_rot, idx._code_cb = opq_train(
                    live, m, device=idx._device)
            else:
                idx._code_cb = pq_train(live, m, device=idx._device)
        if idx._code_rot is not None:
            rows_c = rows_c @ idx._code_rot
        return pq_encode_np(rows_c, idx._code_cb, device=idx._device)
    if mat.dtype == np.int8:
        return mat
    mat = idx._prep_for_metric(np.asarray(mat, np.float32))
    if idx._code_a is None:
        live = mat[valid] if not valid.all() else mat
        idx._code_a, idx._code_b = sq8_train(live)
    return sq8_encode_np(mat, idx._code_a, idx._code_b)


def _pq_stats(idx, codes: np.ndarray, cb: np.ndarray,
              rot: Optional[np.ndarray], n_pad: int) -> np.ndarray:
    """(n_pad,) float64 PQ row stats on the host (``_ivf_code.py:105-137``):
    ``||r_hat||^2`` (zero for inner_product, whose kernel score is
    ``-2 <q, x_hat>``), and in residual mode the full
    ``||c_T + r_hat||^2 = ||r_hat||^2 + 2 <c_T, r_hat> + ||c_T||^2`` with
    ``<c_T, r_hat>`` from a (C, M, 256) centroid-codeword table.
    Residual mode also sets the device centroids and row -> list map."""
    m = codes.shape[1]
    s2 = np.zeros(n_pad, dtype=np.float64)
    if idx.metric != "inner_product":
        cb_sq = (cb.astype(np.float64) ** 2).sum(-1)
        for mi in range(m):
            s2 += cb_sq[mi][codes[:, mi]]
    if idx.pq_residual:
        cents_c = idx._pq_cents_codec(rot)
        cc64 = cents_c.astype(np.float64)
        ipc = np.einsum("lms,mvs->lmv", cc64.reshape(cc64.shape[0], m, -1),
                        cb.astype(np.float64))
        asg_pad = np.zeros(n_pad, dtype=np.int32)
        asg_pad[:idx._host.shape[0]] = idx._assign_host
        s2 += (cc64 ** 2).sum(-1)[asg_pad]
        for mi in range(m):
            s2 += 2.0 * ipc[asg_pad, mi, codes[:, mi]]
        idx._cents_codec_dev = torch.from_numpy(
            cents_c.astype(np.float32)).to(idx._device)
        # Host numpy until the upload places it (one device or sharded).
        idx._row2list_dev = asg_pad
    return s2


def upload_tiled(idx, sq8_codes: Optional[np.ndarray] = None, sq8_ab=None,
                 pq_codes: Optional[np.ndarray] = None,
                 pq_cb: Optional[np.ndarray] = None,
                 pq_rot: Optional[np.ndarray] = None) -> None:
    """
    Tiled device build: codes in tiles (SQ8 int8 (n_tiles, d_pad,
    TILE_ROWS) or PQ uint8 (n_tiles, M, TILE_ROWS)), the per-row stats
    with +inf on dead rows and on the padding past the last row, the
    sublist CSR and the list -> sublist slot table.

    :param sq8_codes: (n, dim) int8 codes of the rows-tier mirror, with
        their codec ``sq8_ab``; None on the code tier, whose mirror is the
        codes.
    :param pq_codes: (n, M) uint8 codes of the rows-tier mirror, with
        their codebooks ``pq_cb`` and OPQ rotation ``pq_rot`` (trained per
        layout, never persisted); None on the code tier.
    """
    idx._dev = idx._dev_sq = idx._dev_norm = None
    idx._dev_valid = idx._dev_offsets = idx._dev_lens = None
    idx._dev_first_virt = None
    idx._cents_codec_dev = idx._row2list_dev = None
    n = idx._host.shape[0]
    dim = idx._dim
    d_pad = idx._centroids_np.shape[1]
    n_tiles = max(1, -(-n // TILE_ROWS))
    mesh = idx._make_mesh()
    if mesh is not None:
        # Every shard owns whole tiles: round the tile count up to the
        # shard count (the surplus rows are dead).
        n_tiles = -(-n_tiles // mesh.size) * mesh.size
    n_pad = n_tiles * TILE_ROWS
    dead = np.ones(n_pad, dtype=bool)
    dead[:n] = ~idx._valid_host
    dev = idx._device
    if idx._pq_m(idx.dtype) is not None:
        m, _, perm = idx._pq_grid()
        cb = pq_cb if pq_cb is not None else idx._code_cb
        rot = pq_rot if pq_codes is not None else idx._code_rot
        codes = np.zeros((n_pad, m), dtype=np.uint8)
        codes[:n] = pq_codes if pq_codes is not None else idx._host
        s2 = _pq_stats(idx, codes, cb, rot, n_pad).astype(np.float32)
        tiles = codes.reshape(n_tiles, TILE_ROWS, m).transpose(0, 2, 1)
        idx._cb_dev = torch.from_numpy(cb.astype(np.float32)).to(dev)
        # OPQ: the query transform is one matrix (interleave, then
        # rotation); plain PQ gathers by the interleave.
        idx._perm_dev = torch.from_numpy(
            compose_transform(perm, rot) if rot is not None
            else perm.astype(np.int64)).to(dev)
    else:
        code_a, code_b = sq8_ab if sq8_ab is not None \
            else (idx._code_a, idx._code_b)
        codes = np.zeros((n_pad, d_pad), dtype=np.int8)
        codes[:n, :dim] = sq8_codes if sq8_codes is not None else idx._host
        # Padding dims: scale 1e-12 and offset 0, so zero codes and zero
        # query dims add nothing to any score term.
        a_p = np.full(d_pad, 1e-12, dtype=np.float32)
        b_p = np.zeros(d_pad, dtype=np.float32)
        a_p[:dim] = code_a
        b_p[:dim] = code_b
        # Stats and tiles in chunks of ~1M rows: never a float32 copy of
        # the whole mirror.
        s2 = np.empty(n_pad, dtype=np.float32)
        tiles = np.empty((n_tiles, d_pad, TILE_ROWS), dtype=np.int8)
        t_chunk = max(1, (1 << 20) // TILE_ROWS)
        for t0 in range(0, n_tiles, t_chunk):
            t1 = min(t0 + t_chunk, n_tiles)
            r0, r1 = t0 * TILE_ROWS, t1 * TILE_ROWS
            if idx.metric == "inner_product":
                s2[r0:r1] = 0.0
            else:
                u = codes[r0:r1].astype(np.float32)
                u *= a_p
                s2[r0:r1] = np.einsum("nd,nd->n", u, u)
            tiles[t0:t1] = codes[r0:r1] \
                .reshape(t1 - t0, TILE_ROWS, d_pad).transpose(0, 2, 1)
        idx._sq8_a = torch.from_numpy(a_p).to(dev)
        idx._sq8_b = torch.from_numpy(b_p).to(dev)
    s2[dead] = np.inf
    c_count = idx._centroids_np.shape[0]
    lens = np.bincount(idx._assign_host, minlength=c_count).astype(np.int64)
    idx._capacity = n_pad
    if mesh is not None:
        _upload_sharded(idx, mesh, tiles, s2, lens)
        return
    idx._mesh = None
    idx._dev3 = torch.from_numpy(np.ascontiguousarray(tiles)).to(dev)
    idx._s2t = torch.from_numpy(s2.reshape(n_tiles, 1, TILE_ROWS)).to(dev)
    if idx._row2list_dev is not None:
        idx._row2list_dev = torch.from_numpy(idx._row2list_dev).to(dev)
    v_tile, v_col, v_len, v_orig, _ = build_tiled_csr(
        lens[None, :], np.zeros(1, dtype=np.int64))
    idx._v_tile = torch.from_numpy(v_tile).to(dev)
    idx._v_col = torch.from_numpy(v_col).to(dev)
    idx._v_len = torch.from_numpy(v_len).to(dev)
    idx._slot_table = torch.from_numpy(
        build_slot_table(v_orig, c_count)).long().to(dev)
    idx._dev_centroids = torch.from_numpy(
        idx._centroids_np.astype(np.float32)).to(dev)
    idx._n_virtual = len(v_len)


def _upload_sharded(idx, mesh, tiles: np.ndarray, s2: np.ndarray,
                    lens: np.ndarray) -> None:
    """The mesh branch of :func:`upload_tiled` (``_ivf_code.py:191-241``):
    per-shard clipped CSR and slot tables (a list cut by a shard boundary
    is probed by both owners), the tiles, stats and row -> list map
    sharded on the tile axis straight from host memory (the multi-GB tile
    buffer is never staged on one device), the codec and centroids
    replicated once."""
    n_tiles = tiles.shape[0]
    c_count = idx._centroids_np.shape[0]
    vt, vc, vl, st = shard_tiled_layout(lens, idx._capacity, mesh.size,
                                        c_count)
    idx._dev3 = shard_rows(mesh, tiles)
    idx._s2t = shard_rows(mesh, s2.reshape(n_tiles, 1, TILE_ROWS))
    idx._v_tile = shard_rows(mesh, vt)
    idx._v_col = shard_rows(mesh, vc)
    idx._v_len = shard_rows(mesh, vl)
    idx._slot_table = shard_rows(mesh, st.astype(np.int64))
    if idx._row2list_dev is not None:
        idx._row2list_dev = shard_rows(mesh, idx._row2list_dev)
    if idx._pq_m(idx.dtype) is not None:
        idx._cb_dev = replicate(mesh, idx._cb_dev)
        idx._perm_dev = replicate(mesh, idx._perm_dev)
        if idx._cents_codec_dev is not None:
            idx._cents_codec_dev = replicate(mesh, idx._cents_codec_dev)
    else:
        idx._sq8_a = replicate(mesh, idx._sq8_a)
        idx._sq8_b = replicate(mesh, idx._sq8_b)
    idx._dev_centroids = replicate(
        mesh, idx._centroids_np.astype(np.float32))
    # The total slot count over the shards' clipped tables, as JAX.
    idx._n_virtual = int(vl.size)
    idx._mesh = mesh


def poison_rows(idx, rows) -> None:
    """Set removed rows' stats to +inf in place, on their shard under a
    mesh: the tiled kernels score ``s2 - 2<t, u>`` (K7) and
    ``s2 - 2 sum LUT`` (K8), so a +inf row never wins."""
    r = np.asarray(rows, dtype=np.int64)
    tile, col = r // TILE_ROWS, r % TILE_ROWS
    if idx._mesh is None:
        idx._s2t[torch.as_tensor(tile, device=idx._s2t.device), 0,
                 torch.as_tensor(col, device=idx._s2t.device)] = float("inf")
        return
    per = idx._s2t[0].shape[0]
    for s, part in enumerate(idx._s2t):
        sel = tile // per == s
        if sel.any():
            part[torch.as_tensor(tile[sel] - s * per, device=part.device), 0,
                 torch.as_tensor(col[sel], device=part.device)] = float("inf")


def query_tiled(idx, q_p: torch.Tensor, k_dev: int):
    """Serve one padded query batch through the tiled engine (K7 for SQ8,
    K8 for PQ), or return None when the index holds no tiled state (the
    row-major engines of ``_ivf_rows.query_rows`` serve it)."""
    if idx._dev3 is None:
        return None
    if idx._mesh is not None:
        return _query_sharded(idx, q_p, k_dev)
    kw = dict(k=k_dev, nprobe_orig=min(idx.nprobe, idx._centroids_np.shape[0]),
              rerank="score" if idx.rerank == "score" else "gather",
              metric=idx.metric)
    if idx._pq_m(idx.dtype) is not None:
        return ivf_query_dma_tiled_table_pq(
            idx._dev3, idx._s2t, idx._cb_dev, idx._perm_dev,
            idx._dev_centroids, idx._slot_table, idx._v_tile, idx._v_col,
            idx._v_len, q_p, res_cents=idx._cents_codec_dev,
            row2list=idx._row2list_dev, **kw)
    return ivf_query_dma_tiled_table(
        idx._dev3, idx._s2t, idx._sq8_a, idx._sq8_b, idx._dev_centroids,
        idx._slot_table, idx._v_tile, idx._v_col, idx._v_len, q_p, **kw)


def _query_sharded(idx, q_p: torch.Tensor, k_dev: int):
    """The mesh branch of :func:`query_tiled` (``_ivf_code.py:271-311``):
    K7 or K8 (and K3) on every shard, the k-sized merge."""
    mesh = idx._mesh
    kw = dict(k=k_dev, nprobe_orig=min(idx.nprobe, idx._centroids_np.shape[0]),
              rerank="score" if idx.rerank == "score" else "gather",
              metric=idx.metric)
    if idx._pq_m(idx.dtype) is not None:
        return sharded_ivf_query_tiled_pq(
            mesh, idx._dev3, idx._s2t, idx._cb_dev, idx._perm_dev,
            idx._dev_centroids, idx._slot_table, idx._v_tile, idx._v_col,
            idx._v_len, q_p, res_cents=idx._cents_codec_dev,
            row2list=idx._row2list_dev, **kw)
    return sharded_ivf_query_tiled(
        mesh, idx._dev3, idx._s2t, idx._sq8_a, idx._sq8_b,
        idx._dev_centroids, idx._slot_table, idx._v_tile, idx._v_col,
        idx._v_len, q_p, **kw)
