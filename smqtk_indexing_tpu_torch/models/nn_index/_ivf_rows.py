"""
Rows-tier engine of the port's ``IvfNearestNeighborsIndex``:
``smqtk_indexing_tpu/models/nn_index/_ivf_rows.py`` (``upload_rows``
:24-187, ``query_rows`` :226-300).

The host mirror is the float32 rows, sorted by list. The device holds
them row-major (f32, bf16, SQ8 codes or PQ codes, with a codec trained per
layout), with the list balancer's sublist CSR. The routed cells
(``ivf._tiled_rows_ok``: SQ8 with ``rerank='score'``, euclidean PQ, with
or without ``pq_residual``) take the tiled engine instead (``_ivf_code``),
with a per-layout codec that is never persisted. Row-major PQ serves
inner_product and cosine, and euclidean PQ (with or without residuals)
when a switch takes the routing away (``SMQTK_TPU_NO_ROWS_TILED`` or
``SMQTK_TPU_NO_DMA_IVF`` at the layout); ``SMQTK_TPU_NO_DMA_IVF`` at a
query also takes K6 away (``ops/ivf.ivf_query``).
Functions take the index instance as ``idx`` and run under its lock.

Under a mesh (``_ivf_rows.py:187-219`` and ``:232-263``) the tiled routing
and K6 are off, as in JAX (``ivf.py:298, :329``): the row-major tensors
are built on the mesh's first device and row-sharded, each shard gets its
clipped sublist CSR (``parallel.sharded_ivf.shard_csr``), and queries run
``ops/ivf.ivf_query`` or ``ivf_query_pq`` a shard
(``parallel.sharded_ivf``).
"""
from __future__ import annotations

import numpy as np
import torch

from smqtk_indexing_tpu_torch.models.nn_index._ivf_code import upload_tiled
from smqtk_indexing_tpu_torch.ops.device import (
    capacity_for, pad_rows_np, pow2_at_least,
)
from smqtk_indexing_tpu_torch.ops.ivf import ivf_query, ivf_query_pq
from smqtk_indexing_tpu_torch.ops.ivf_scan import L_MAX, ivf_query_dma
from smqtk_indexing_tpu_torch.ops.opq import compose_transform, opq_train
from smqtk_indexing_tpu_torch.ops.pq import (
    pq_build_store, pq_encode_np, pq_prep_queries, pq_residual_build_store,
    pq_train, pq_transform_queries,
)
from smqtk_indexing_tpu_torch.ops.sq8 import (
    sq8_build_store, sq8_encode_np, sq8_train,
)
from smqtk_indexing_tpu_torch.parallel.mesh import replicate, shard_rows
from smqtk_indexing_tpu_torch.parallel.sharded_ivf import (
    shard_csr, sharded_ivf_query, sharded_ivf_query_pq,
)

_FLOAT_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def balance_lists(lens: np.ndarray, n: int):
    """
    The rows tier's list balancer (``_ivf_rows.py:125-171``): a list longer
    than ``cap`` splits into contiguous sublists that share its centroid,
    where ``cap`` is twice the mean list length, at least 32 and at most
    ``L_MAX - 32`` (so every sublist fits K6's window). An empty list keeps
    one empty slot, so it is ranked as FAISS ranks it.

    :param lens: (C,) list lengths over a list-sorted layout of ``n`` rows.
    :return: (v_off, v_len, v_orig) int32 sublist starts, lengths and
        original lists, and first_virt (C,) int32, one slot per list.
    """
    c_count = lens.shape[0]
    offsets = np.zeros(c_count, dtype=np.int64)
    offsets[1:] = np.cumsum(lens)[:-1]
    cap = min(max(int(np.ceil(2.0 * max(n, 1) / c_count)), 32), L_MAX - 32)
    v_off, v_len, v_orig = [], [], []
    for li in range(c_count):
        length, start = int(lens[li]), int(offsets[li])
        if length == 0:
            v_off.append(start)
            v_len.append(0)
            v_orig.append(li)
            continue
        for lo in range(0, length, cap):
            v_off.append(start + lo)
            v_len.append(min(cap, length - lo))
            v_orig.append(li)
    v_orig = np.asarray(v_orig, dtype=np.int32)
    first_virt = np.searchsorted(v_orig, np.arange(c_count)).astype(np.int32)
    return (np.asarray(v_off, dtype=np.int32),
            np.asarray(v_len, dtype=np.int32), v_orig, first_virt)


def _upload_tiled_routed(idx) -> None:
    """The routed cells' tiled build, with a codec trained on this
    layout's live rows: SQ8, or PQ over the codec grid (the residuals
    ``x_T - c_T[list]`` with ``pq_residual``; an OPQ rotation learned on
    them for 'opq<M>')."""
    live_mask = None if idx._valid_host.all() else idx._valid_host
    m = idx._pq_m(idx.dtype)
    if m is None:
        live = idx._host if live_mask is None else idx._host[live_mask]
        a, b = sq8_train(live)
        upload_tiled(idx, sq8_codes=sq8_encode_np(idx._host, a, b),
                     sq8_ab=(a, b))
        return
    rows_c = idx._pq_prep_rows(idx._host, rotate=False)
    if idx.pq_residual:
        rows_c = rows_c - idx._pq_cents_codec(None)[idx._assign_host]
    live = rows_c if live_mask is None else rows_c[live_mask]
    rot = None
    if idx._pq_rotate(idx.dtype):
        rot, cb = opq_train(live, m, device=idx._device)
        rows_c = rows_c @ rot
    else:
        cb = pq_train(live, m, device=idx._device)
    upload_tiled(idx, pq_codes=pq_encode_np(rows_c, cb, device=idx._device),
                 pq_cb=cb, pq_rot=rot)


def upload_rows(idx) -> None:
    """Rows-tier device build, or the tiled build of the routed cells."""
    if idx._tiled_rows_ok():
        _upload_tiled_routed(idx)
        return
    # A re-layout may cross a routing switch: the query path prefers tiled
    # state when present, so none from a routed layout survives here.
    idx._dev3 = idx._s2t = None
    idx._v_tile = idx._v_col = idx._v_len = idx._slot_table = None
    idx._cents_codec_dev = idx._row2list_dev = None
    dev = idx._device
    n = idx._host.shape[0]
    idx._capacity = capacity_for(n)
    d_pad = idx._centroids_np.shape[1]
    valid = np.zeros(idx._capacity, dtype=bool)
    valid[:n] = idx._valid_host
    if idx.dtype == "sq8":
        # int8 codes; the scoring stats are the dequantized rows', so the
        # surrogate and the exact re-rank agree.
        idx._sq8_a, idx._sq8_b, idx._dev, _, nrm = sq8_build_store(
            idx._host, idx._valid_host, idx._capacity, d_pad, idx._dim, dev)
        idx._dev_sq = nrm * nrm
        idx._dev_norm = nrm
    elif idx._pq_m(idx.dtype) is not None:
        # PQ codes in list-sorted order (pq_build_store: the interleave,
        # a per-layout codec, exact reconstruction-norm stats; with
        # pq_residual the residuals to the list centroids, as the JAX
        # rows tier off the tiled routing, _ivf_rows.py:84-104). Padding
        # rows decode to some codeword; windows never cover them, and
        # their stats are zeroed anyway.
        if idx.pq_residual:
            (perm, rot, _, idx._pq_cb_dev, idx._dev, s2, cents_c,
             idx._row2list_dev) = pq_residual_build_store(
                idx._host, idx._valid_host, idx._capacity, d_pad,
                idx._pq_m(idx.dtype), idx._centroids_np, idx._assign_host,
                dev, rotate=idx._pq_rotate(idx.dtype))
            idx._cents_codec_dev = torch.from_numpy(
                cents_c.astype(np.float32)).to(dev)
        else:
            (perm, rot, _, idx._pq_cb_dev, idx._dev, s2) = pq_build_store(
                idx._host, idx._valid_host, idx._capacity, d_pad,
                idx._pq_m(idx.dtype), dev,
                rotate=idx._pq_rotate(idx.dtype))
        idx._dev_sq = torch.where(torch.from_numpy(valid).to(dev), s2, 0.0)
        idx._dev_norm = torch.sqrt(torch.clamp(idx._dev_sq, min=0.0))
        idx._perm_dev = torch.from_numpy(
            compose_transform(perm, rot) if rot is not None
            else perm.astype(np.int64)).to(dev)
    else:
        padded = pad_rows_np(idx._host, idx._capacity, d_pad)
        sq = np.zeros(idx._capacity, dtype=np.float32)
        sq[:n] = np.einsum("ij,ij->i", idx._host, idx._host)
        idx._dev = torch.from_numpy(padded).to(dev, _FLOAT_DTYPES[idx.dtype])
        idx._dev_sq = torch.from_numpy(sq).to(dev)
        idx._dev_norm = torch.sqrt(idx._dev_sq)
    idx._dev_valid = torch.from_numpy(valid).to(dev)
    c_count = idx._centroids_np.shape[0]
    lens = np.bincount(idx._assign_host, minlength=c_count)
    v_off, v_len, v_orig, first_virt = balance_lists(lens, n)
    idx._n_virtual = len(v_off)
    idx._dev_first_virt = torch.from_numpy(first_virt).long().to(dev)
    # Most sublists of one list: the query's probe budget scales by it.
    idx._max_split = int(np.bincount(v_orig).max())
    idx._l_max_raw = max(int(v_len.max()), 1)
    idx._l_max = pow2_at_least(idx._l_max_raw)
    # Centroids stay float over int8 codes; bf16 storage keeps them bf16;
    # PQ ranks them on the codec grid, as its queries.
    cent = idx._centroids_np[v_orig].astype(np.float32)
    if idx._pq_m(idx.dtype) is not None:
        cent = pq_prep_queries(cent, perm, rot)
    idx._dev_centroids = torch.from_numpy(cent).to(
        dev, torch.bfloat16 if idx.dtype == "bfloat16" else torch.float32)
    idx._dev_offsets = torch.from_numpy(v_off).long().to(dev)
    idx._dev_lens = torch.from_numpy(v_len).long().to(dev)
    idx._mesh = idx._make_mesh()
    if idx._mesh is not None:
        _shard_rows_state(idx, v_off, v_len)


def _shard_rows_state(idx, v_off: np.ndarray, v_len: np.ndarray) -> None:
    """Row-shard the rows tier's device state (``_ivf_rows.py:187-219``):
    rows, stats, liveness and (residual PQ) the row -> list map sharded,
    each shard's clipped CSR view, the centroids and codecs replicated.
    The query transform stays on the first device."""
    mesh = idx._mesh
    loc_off, loc_len = shard_csr(v_off, v_len, idx._capacity, mesh.size)
    idx._dev, idx._dev_sq, idx._dev_norm, idx._dev_valid = (
        shard_rows(mesh, t) for t in (idx._dev, idx._dev_sq,
                                      idx._dev_norm, idx._dev_valid))
    idx._dev_offsets = shard_rows(mesh, loc_off.astype(np.int64))
    idx._dev_lens = shard_rows(mesh, loc_len.astype(np.int64))
    idx._dev_centroids = replicate(mesh, idx._dev_centroids)
    idx._dev_first_virt = replicate(mesh, idx._dev_first_virt)
    if idx.dtype == "sq8":
        idx._sq8_a = replicate(mesh, idx._sq8_a)
        idx._sq8_b = replicate(mesh, idx._sq8_b)
    if idx._pq_m(idx.dtype) is not None:
        idx._pq_cb_dev = replicate(mesh, idx._pq_cb_dev)
        if idx._row2list_dev is not None:
            idx._row2list_dev = shard_rows(mesh, idx._row2list_dev)
            idx._cents_codec_dev = replicate(mesh, idx._cents_codec_dev)


def query_rows(idx, q_p: torch.Tensor, k_dev: int, nprobe: int,
               first_virt, nprobe_orig, has_dead: bool):
    """Serve one padded query batch through K6 (``_dma_eligible``) or the
    plain list gathers (``ops/ivf.ivf_query``, ``ivf_query_pq``)."""
    dq = (idx._sq8_a, idx._sq8_b) if idx.dtype == "sq8" else None
    if idx._mesh is not None and idx._pq_m(idx.dtype) is not None:
        return sharded_ivf_query_pq(
            idx._mesh, idx._dev, idx._pq_cb_dev, idx._dev_sq,
            idx._dev_valid, idx._dev_centroids, idx._dev_offsets,
            idx._dev_lens, pq_transform_queries(q_p, idx._perm_dev),
            k=k_dev, nprobe=nprobe, l_max=idx._l_max, metric=idx.metric,
            first_virt=first_virt, nprobe_orig=nprobe_orig,
            has_dead=has_dead, res_cents=idx._cents_codec_dev,
            row2list=idx._row2list_dev)
    if idx._mesh is not None:
        return sharded_ivf_query(
            idx._mesh, idx._dev, idx._dev_sq, idx._dev_norm,
            idx._dev_valid, idx._dev_centroids, idx._dev_offsets,
            idx._dev_lens, q_p, k=k_dev, nprobe=nprobe, l_max=idx._l_max,
            metric=idx.metric, dq=dq, first_virt=first_virt,
            nprobe_orig=nprobe_orig, has_dead=has_dead)
    if idx._pq_m(idx.dtype) is not None:
        return ivf_query_pq(
            idx._dev, idx._pq_cb_dev, idx._dev_sq, idx._dev_valid,
            idx._dev_centroids, idx._dev_offsets, idx._dev_lens,
            pq_transform_queries(q_p, idx._perm_dev),
            k=k_dev, nprobe=nprobe, l_max=idx._l_max, metric=idx.metric,
            first_virt=first_virt, nprobe_orig=nprobe_orig,
            has_dead=has_dead, res_cents=idx._cents_codec_dev,
            row2list=idx._row2list_dev)
    if idx._dma_eligible():
        return ivf_query_dma(
            idx._dev, idx._dev_valid, idx._dev_centroids, idx._dev_offsets,
            idx._dev_lens, q_p, k=k_dev, n_probe=nprobe,
            first_virt=first_virt, nprobe_orig=nprobe_orig,
            has_dead=has_dead, dq=dq)
    return ivf_query(
        idx._dev, idx._dev_sq, idx._dev_norm, idx._dev_valid,
        idx._dev_centroids, idx._dev_offsets, idx._dev_lens, q_p, k=k_dev,
        nprobe=nprobe, l_max=idx._l_max, metric=idx.metric, dq=dq,
        first_virt=first_virt, nprobe_orig=nprobe_orig, has_dead=has_dead)
