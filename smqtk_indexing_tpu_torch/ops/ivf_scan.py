"""
IVF list scans through hand-written kernels: the PyTorch counterpart of
``smqtk_indexing_tpu/ops/pallas_ivf.py`` (named for what it does, since
there is no Pallas here).

Two layouts, one kernel each:

- **Row-major CSR** (the rows tier, euclidean): the database is (N, d) f32,
  bf16 or int8 codes sorted by list id. ``ivf_list_scores`` (K6,
  ``csrc/ivf_list_scores.cu``) scores, per (query, probe), a window of
  ``L_MAX`` rows starting at a clamped list start:
  ``sum((a u)^2) - 2 <t, u>`` inside the probe's ``[lo, hi)`` and +inf
  outside. ``a`` is ones for float storage and the SQ8 scale for codes;
  ``t`` is the query, or its codec fold ``(q - b) a``.
  ``ivf_query_dma`` selects probes, runs it, and re-ranks the winners
  exactly.
- **Tiled-transposed** (the code tier, and rows-tier SQ8 with
  ``rerank='score'``): int8 codes in (n_tiles, d, ``TILE_ROWS``) tiles, row
  ``r`` at ``[r // TILE_ROWS, :, r % TILE_ROWS]``, with per-row stats
  ``s2`` in (n_tiles, 1, TILE_ROWS). Lists are cut into sublists that fit
  a ``W_TILED``-wide window (``build_tiled_csr``).
  ``ivf_list_scores_tiled`` (K7, ``csrc/ivf_list_scores_tiled.cu``)
  scores, per (query, probe slot), the window
  ``s2 - 2 <t, u>`` inside ``[lo, hi)`` and +inf outside.
  ``ivf_query_dma_tiled_table`` ranks the original centroids, expands the
  nearest lists to their sublist windows (``build_slot_table``,
  ``_expand_slots``), runs the kernel, and finishes by the surrogate
  (``rerank='score'``) or by an exact re-rank of the winners fetched
  through ``fused_scan.seg_gather_tiled`` (K3).
- **Tiled PQ** (the code tier with ``dtype='pq<M>'`` / ``'opq<M>'``, and
  the rows tier's euclidean PQ): uint8 PQ codes in (n_tiles, M,
  ``TILE_ROWS``) tiles. ``ivf_list_scores_tiled_pq`` (K8,
  ``csrc/ivf_list_scores_tiled_pq.cu``) scores, per (query, probe slot),
  the window ``s2 - 2 sum_m LUT[m, code_m]`` inside ``[lo, hi)`` and +inf
  outside, with the query's (M, 256) table of codeword inner products.
  ``ivf_query_dma_tiled_table_pq`` takes queries to the codec grid (the
  interleave, or the OPQ matrix), builds the table, adds residual PQ's
  per-probe ``-2 <q, c>`` after the kernel, and finishes by the surrogate
  or by an exact re-rank of the winners' codes fetched through K3.

On a CUDA tensor each wrapper launches its kernel or raises; on a CPU
tensor it runs its plain PyTorch version (``*_reference``). The layouts,
window starts and row ids are the JAX package's, so the index math is
tested against it on the CPU. What the TPU needed and the card does not
(DMA double buffering, scalar prefetch, the probes-per-step lane order of
K6's output) is not carried over: K6 writes its scores as (B, P, L_MAX).
``P_STEP_TILED`` still pads the tiled probe budget, so the operands match
the JAX package's.

Not ported here: ``ivf_query_dma_tiled`` (the virtual-centroid form, which
only a JAX test calls).
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops import _kernels
from smqtk_indexing_tpu_torch.ops.device import require_full_f32
from smqtk_indexing_tpu_torch.ops.fused_scan import (
    SEG, seg_gather_tiled, topk_smallest,
)
from smqtk_indexing_tpu_torch.ops.ivf import (
    centroid_scores, probe_eligibility, select_probes, smallest,
)
from smqtk_indexing_tpu_torch.ops.pq import (
    K_SUB, _dequant, pq_transform_queries,
)
from smqtk_indexing_tpu_torch.ops.scan import (
    _exact_selected, exact_rerank_decoded, pad_to_k,
)
from smqtk_indexing_tpu_torch.ops.sq8 import sq8_decode

#: Rows of one row-major window (K6). The rows balancer caps sublists at
#: ``L_MAX - 32``; the slack absorbs the 32-row alignment of the start.
L_MAX = 512

#: Columns of one tiled window (K7). ``build_tiled_csr`` cuts sublists at
#: ``W_TILED - 128`` and at tile ends, so a window whose start is rounded
#: down to 128 columns always holds its sublist.
W_TILED = 640

#: The tiled probe budget is padded to a multiple of this (the TPU
#: kernel's probes per grid step), so operands match the JAX package's.
P_STEP_TILED = 64

#: Rows of one tile of the tiled-transposed layout.
TILE_ROWS = 4096

#: Launches of each CUDA kernel of this module in this process. A wrapper
#: adds one where it launches its kernel and nowhere else.
LAUNCHES = {"ivf_list_scores": 0, "ivf_list_scores_tiled": 0,
            "ivf_list_scores_tiled_pq": 0}

#: Cap on a query block's f32 score block (B, P, window) plus, in gather
#: mode, its gathered winner segments: queries run in blocks under it.
#: The serving line (B=1024, a 64-slot budget) fits one block; an
#: exhaustive probe of a 1M-row index takes some 30 MB per query.
SCORE_BYTES = 1 << 28

#: Cap on the f32 candidate block a plain version materialises.
REFERENCE_BYTES = 1 << 28


# ---------------------------------------------------------------------------
# Layout helpers (numpy; pallas_ivf.py:332-394, :1068-1083)
# ---------------------------------------------------------------------------

def build_tiled_csr(chunk_lens, chunk_bases, cap: int = W_TILED - 128,
                    tile: int = TILE_ROWS):
    """
    Virtual-sublist CSR over the tiled layout (``pallas_ivf.py:332-382``):
    chunk ``c`` holds rows ``[chunk_bases[c], ...)`` sorted by list id, so
    list ``li`` is a union of per-chunk runs; each run splits at ``cap``
    rows and at tile ends.

    :param chunk_lens: (n_chunks, C) per-chunk per-list row counts.
    :param chunk_bases: (n_chunks,) global first row of each chunk.
    :return: (v_tile, v_col, v_len, v_orig, first_virt) int32 arrays:
        sublist tile, in-tile start column, length and original list, plus
        one representative slot per list (an empty list gets a dead
        length-0 slot, so it is ranked as FAISS ranks it).
    """
    chunk_lens = np.asarray(chunk_lens)
    n_chunks, c_lists = chunk_lens.shape
    v_off, v_len, v_orig = [], [], []
    for c in range(n_chunks):
        lens_c = chunk_lens[c]
        offs = chunk_bases[c] + np.concatenate([[0], np.cumsum(lens_c)[:-1]])
        for li in np.nonzero(lens_c)[0]:
            start, end = int(offs[li]), int(offs[li] + lens_c[li])
            while start < end:
                stop = min(end, start + cap, (start // tile + 1) * tile)
                v_off.append(start)
                v_len.append(stop - start)
                v_orig.append(li)
                start = stop
    v_off = np.asarray(v_off, dtype=np.int64)
    v_len = np.asarray(v_len, dtype=np.int32)
    v_orig = np.asarray(v_orig, dtype=np.int32)
    missing = np.setdiff1d(np.arange(c_lists), v_orig)
    if missing.size:
        v_off = np.concatenate([v_off, np.zeros(missing.size, np.int64)])
        v_len = np.concatenate([v_len, np.zeros(missing.size, np.int32)])
        v_orig = np.concatenate([v_orig, missing.astype(np.int32)])
    first_virt = np.full(c_lists, -1, dtype=np.int32)
    for i, li in enumerate(v_orig):
        if first_virt[li] < 0:
            first_virt[li] = i
    return ((v_off // tile).astype(np.int32),
            (v_off % tile).astype(np.int32), v_len, v_orig, first_virt)


def probe_budget(v_orig, nprobe_orig: int, step: int = P_STEP_TILED) -> int:
    """Probe-slot budget that covers the ``nprobe_orig`` largest lists'
    sublists (+1 tied list, +8), padded to ``step``
    (``pallas_ivf.py:385-394``)."""
    counts = np.bincount(np.asarray(v_orig))
    budget = int(np.sort(counts)[::-1][:nprobe_orig + 1].sum()) + 8
    return -(-budget // step) * step


def build_slot_table(v_orig, c_lists: int) -> np.ndarray:
    """(C, S_max) int32 table of each original list's sublist slots, -1
    padded (``pallas_ivf.py:1068-1083``)."""
    v_orig = np.asarray(v_orig)
    counts = np.bincount(v_orig, minlength=c_lists)
    table = np.full((c_lists, int(counts.max())), -1, dtype=np.int32)
    fill = np.zeros(c_lists, dtype=np.int64)
    for slot, li in enumerate(v_orig):
        table[li, fill[li]] = slot
        fill[li] += 1
    return table


def _expand_slots(slot_table, lists, v_tile, v_col, v_len, tile_n: int):
    """
    Expand selected original lists into their sublist windows
    (``pallas_ivf.py:933-963``): per slot the tile ``ti``, the window start
    ``c0`` (rounded down to 128 and clamped so the window fits the tile)
    and the local window ``[lo, hi)``. Dead (-1) slots and the padding up
    to a multiple of ``P_STEP_TILED`` are zero-length windows.

    :return: (ti, c0, lo, hi), each (B, n_probe) int32.
    """
    b = lists.shape[0]
    slots = slot_table[lists]                    # (B, n_orig, S_max)
    s_max = slot_table.shape[1]
    dead = slots < 0
    slots_c = torch.clamp(slots, min=0)
    ln = torch.where(dead, 0, v_len[slots_c])
    ti = torch.where(dead, 0, v_tile[slots_c])
    col = torch.where(dead, 0, v_col[slots_c])
    c0 = torch.clamp(torch.div(col, 128, rounding_mode="floor") * 128,
                     max=tile_n - W_TILED)
    lo = col - c0
    hi = lo + ln
    p_raw = lists.shape[1] * s_max
    n_probe = -(-p_raw // P_STEP_TILED) * P_STEP_TILED

    def flat(x):
        x = x.reshape(b, p_raw).to(torch.int32)
        pad = n_probe - p_raw
        if pad:
            x = torch.cat([x, torch.zeros((b, pad), dtype=torch.int32,
                                          device=x.device)], dim=1)
        return x

    return flat(ti), flat(c0), flat(lo), flat(hi)


# ---------------------------------------------------------------------------
# K6: row-major list windows
# ---------------------------------------------------------------------------

def _check_rows(db, t, a, starts, lo, hi) -> None:
    if db.dim() != 2 or t.dim() != 2 or t.shape[1] != db.shape[1]:
        raise ValueError(f"ivf_list_scores: db {tuple(db.shape)} and t "
                         f"{tuple(t.shape)} must be (N, d) and (B, d)")
    if db.shape[0] < L_MAX:
        raise ValueError(f"ivf_list_scores: N={db.shape[0]} < L_MAX={L_MAX}")
    if db.dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise TypeError(f"ivf_list_scores: db dtype {db.dtype} is not "
                        "float32, bfloat16 or int8")
    if t.dtype != torch.float32 or a.dtype != torch.float32 \
            or a.shape != (db.shape[1],):
        raise TypeError("ivf_list_scores: t (B, d) and a (d,) must be "
                        "float32")
    shape = (t.shape[0], starts.shape[1] if starts.dim() == 2 else -1)
    for name, x in (("starts", starts), ("lo", lo), ("hi", hi)):
        if x.dim() != 2 or tuple(x.shape) != shape:
            raise ValueError(f"ivf_list_scores: {name} must be (B, P)")
    devices = {x.device for x in (db, t, a, starts, lo, hi)}
    if len(devices) != 1:
        raise ValueError(f"ivf_list_scores: tensors on several devices "
                         f"{sorted(map(str, devices))}")


def ivf_list_scores(db: torch.Tensor, t: torch.Tensor, a: torch.Tensor,
                    starts: torch.Tensor, lo: torch.Tensor,
                    hi: torch.Tensor) -> torch.Tensor:
    """
    K6: masked L2 surrogate scores over row-major list windows
    (``pallas_ivf.ivf_list_scores``, ``:127-188``).

    :param db: (N, d) f32, bf16 or int8 list-sorted database, N >= L_MAX.
    :param t: (B, d) f32 queries, or their SQ8 fold ``(q - b) a``.
    :param a: (d,) f32 row scale: ones for float storage, the codec scale.
    :param starts: (B, P) window start rows, ``0 <= start <= N - L_MAX``.
    :param lo, hi: (B, P) local valid window ``[lo, hi)`` within
        ``[0, L_MAX)``; ``lo == hi`` is a dead slot.
    :return: (B, P, L_MAX) f32 ``sum((a u)^2) - 2 <t, u>`` of row
        ``start + l`` for ``lo <= l < hi``, +inf elsewhere.
    """
    _check_rows(db, t, a, starts, lo, hi)
    if db.device.type == "cpu":
        return ivf_list_scores_reference(db, t, a, starts, lo, hi)
    if db.device.type == "cuda":
        return _ivf_list_scores_cuda(db, t, a, starts, lo, hi)
    raise ValueError(f"ivf_list_scores: unsupported device {db.device}")


def _window_mask(lo, hi, width: int, device) -> torch.Tensor:
    lane = torch.arange(width, device=device)
    return (lane >= lo[..., None]) & (lane < hi[..., None])


def ivf_list_scores_reference(db, t, a, starts, lo, hi) -> torch.Tensor:
    """The plain PyTorch version of :func:`ivf_list_scores`: a gather of
    each live window's rows and elementwise f32 products, in blocks of
    live slots under ``REFERENCE_BYTES``; dead slots (``lo == hi``) read
    nothing and are +inf."""
    _check_rows(db, t, a, starts, lo, hi)
    b, p = starts.shape
    d = db.shape[1]
    lane = torch.arange(L_MAX, device=db.device)
    out = torch.full((b, p, L_MAX), math.inf, dtype=torch.float32,
                     device=db.device)
    qi, pi = torch.nonzero(hi > lo, as_tuple=True)
    s_block = max(1, REFERENCE_BYTES // (4 * L_MAX * d))
    for s0 in range(0, qi.numel(), s_block):
        bq, bp = qi[s0:s0 + s_block], pi[s0:s0 + s_block]
        rows = starts[bq, bp, None].long() + lane          # (s, L)
        u = db[rows].float()                                # (s, L, d)
        au = u * a
        ip = (u * t[bq, None, :]).sum(-1)
        scores = (au * au).sum(-1) - 2.0 * ip
        ok = _window_mask(lo[bq, bp], hi[bq, bp], L_MAX, db.device)
        out[bq, bp] = torch.where(ok, scores, math.inf)
    return out


def _ivf_list_scores_cuda(db, t, a, starts, lo, hi) -> torch.Tensor:
    """Launch ``csrc/ivf_list_scores.cu`` on the current stream."""
    d = db.shape[1]
    b, p = starts.shape
    if d % 128:
        raise ValueError(f"ivf_list_scores: d={d} is not a multiple of 128 "
                         "(the index pads it with pad_dim)")
    if not db.is_contiguous() or db.data_ptr() % 16:
        raise ValueError("ivf_list_scores: db must be contiguous and "
                         "16-byte aligned")
    if b * p >= 2 ** 31:
        raise ValueError("ivf_list_scores: grid exceeds 2^31 blocks")
    t, a = t.contiguous(), a.contiguous()
    # The kernel reads t and a as 16-byte vectors: a copy aligns them.
    t, a = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (t, a))
    starts, lo, hi = (x.to(torch.int32).contiguous()
                      for x in (starts, lo, hi))
    out = torch.empty((b, p, L_MAX), dtype=torch.float32, device=db.device)
    name = {torch.float32: "ivf_list_scores_f32",
            torch.bfloat16: "ivf_list_scores_bf16",
            torch.int8: "ivf_list_scores_i8"}[db.dtype]
    stream = torch.cuda.current_stream(db.device).cuda_stream
    with torch.cuda.device(db.device):           # see _kernels.library
        err = getattr(_kernels.library(), name)(
            t.data_ptr(), a.data_ptr(), db.data_ptr(), starts.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), out.data_ptr(), b, p, d, L_MAX,
            db.device.index, stream)
    _kernels.check(err, name)
    LAUNCHES["ivf_list_scores"] += 1
    return out


def row_windows(db: torch.Tensor, centroids: torch.Tensor,
                offsets: torch.Tensor, lens: torch.Tensor, q: torch.Tensor,
                *, n_probe: int, first_virt: Optional[torch.Tensor] = None,
                nprobe_orig: Optional[int] = None, dq=None):
    """
    K6's operands for a query batch (``pallas_ivf.py:215-259``): probe
    selection over the sublist centroids, then per probe a window start
    clamped inside the database and rounded down to 32 rows, and the local
    window ``[lo, hi)`` that absorbs the shift.

    :return: (t (B, d), a (d,), starts, lo, hi (B, n_probe)).
    """
    n, d = db.shape
    q = q.float()
    if dq is not None:
        t = (q - dq[1][None, :]) * dq[0][None, :]
        a = dq[0].float()
    else:
        t = q
        a = torch.ones(d, dtype=torch.float32, device=db.device)
    c_scores = probe_eligibility(
        centroid_scores(q, centroids.float(), "euclidean"), lens,
        first_virt, nprobe_orig)
    lists, ln = select_probes(c_scores, lens, n_probe)
    raw_start = offsets[lists]
    starts = torch.div(torch.clamp(raw_start, max=n - L_MAX), 32,
                       rounding_mode="floor") * 32
    lo = raw_start - starts
    return t, a, starts, lo, lo + ln


def ivf_query_dma(db: torch.Tensor, valid: torch.Tensor,
                  centroids: torch.Tensor, offsets: torch.Tensor,
                  lens: torch.Tensor, q: torch.Tensor, *, k: int,
                  n_probe: int, first_virt: Optional[torch.Tensor] = None,
                  nprobe_orig: Optional[int] = None, has_dead: bool = True,
                  dq=None):
    """
    Euclidean IVF query through K6 (``pallas_ivf.ivf_query_dma``,
    ``:191-308``). Layouts must hold ``max(lens) <= L_MAX - 32`` and
    ``N >= L_MAX``.

    :param dq: optional (a, b) SQ8 codec tensors when ``db`` holds int8
        codes: the kernel scores the codes against ``t = (q - b) a`` and
        the winners re-rank from dequantized rows.
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    """
    b = q.shape[0]
    q = q.float()
    q_sq = (q * q).sum(-1)
    t, a, c_start, lo, hi = row_windows(
        db, centroids, offsets, lens, q, n_probe=n_probe,
        first_virt=first_virt, nprobe_orig=nprobe_orig, dq=dq)
    k_inner = min(k, n_probe * L_MAX)
    q_block = max(1, SCORE_BYTES // (5 * n_probe * L_MAX))
    # (N - L_MAX + 1, L_MAX) view: the liveness of every window start.
    valid_win = valid.unfold(0, L_MAX, 1)
    top_s, top_r = [], []
    for q0 in range(0, b, q_block):
        q1 = min(q0 + q_block, b)
        scores = ivf_list_scores(db, t[q0:q1], a, c_start[q0:q1],
                                 lo[q0:q1], hi[q0:q1])
        if has_dead:
            # Removed rows must not win; windows never cover padding.
            scores = torch.where(valid_win[c_start[q0:q1]], scores,
                                 math.inf)
        s, sel = topk_smallest(scores.reshape(q1 - q0, -1), k_inner)
        # Row of flat score column s: window s // L_MAX, lane s % L_MAX.
        rows = torch.gather(c_start[q0:q1].long(), 1, sel // L_MAX) \
            + sel % L_MAX
        top_s.append(s)
        top_r.append(torch.where(torch.isinf(s), -1, rows))
    top_s, top_r = pad_to_k(torch.cat(top_s), torch.cat(top_r), k)
    return _exact_selected("euclidean", db, q, q_sq, top_s, top_r, dq=dq)


# ---------------------------------------------------------------------------
# K7: tiled-transposed windows
# ---------------------------------------------------------------------------

def _check_tiled(db3, s2t, t, ti, c0, lo, hi) -> None:
    if db3.dim() != 3 or db3.shape[2] < W_TILED or db3.shape[2] % 128:
        raise ValueError(f"ivf_list_scores_tiled: db3 {tuple(db3.shape)} "
                         "must be (n_tiles, d, tile_n), tile_n a multiple "
                         f"of 128 and >= {W_TILED}")
    n_tiles, d, tile_n = db3.shape
    if tuple(s2t.shape) != (n_tiles, 1, tile_n) \
            or s2t.dtype != torch.float32:
        raise ValueError("ivf_list_scores_tiled: s2t must be (n_tiles, 1, "
                         "tile_n) float32")
    if t.dim() != 2 or t.shape[1] != d or t.dtype != torch.float32:
        raise ValueError("ivf_list_scores_tiled: t must be (B, d) float32")
    for name, x in (("ti", ti), ("c0", c0), ("lo", lo), ("hi", hi)):
        if x.dim() != 2 or x.shape != ti.shape or x.shape[0] != t.shape[0]:
            raise ValueError(f"ivf_list_scores_tiled: {name} must be (B, P)")
    devices = {x.device for x in (db3, s2t, t, ti, c0, lo, hi)}
    if len(devices) != 1:
        raise ValueError(f"ivf_list_scores_tiled: tensors on several "
                         f"devices {sorted(map(str, devices))}")


def ivf_list_scores_tiled(db3: torch.Tensor, s2t: torch.Tensor,
                          t: torch.Tensor, ti: torch.Tensor,
                          c0: torch.Tensor, lo: torch.Tensor,
                          hi: torch.Tensor) -> torch.Tensor:
    """
    K7: masked surrogate scores over tiled windows
    (``pallas_ivf.ivf_list_scores_tiled``, ``:468-519``).

    :param db3: (n_tiles, d, tile_n) int8 codes (the CUDA kernel takes
        int8 only; the plain version any dtype).
    :param s2t: (n_tiles, 1, tile_n) f32 row stats, +inf on dead rows.
    :param t: (B, d) f32 query fold.
    :param ti, c0, lo, hi: (B, P) tile, 128-aligned window start column
        (``c0 + W_TILED <= tile_n``) and local window ``[lo, hi)``;
        ``lo == hi`` is a dead slot and reads nothing.
    :return: (B, P, W_TILED) f32 ``s2 - 2 <t, u>`` of column ``c0 + w``
        of tile ``ti`` for ``lo <= w < hi``, +inf elsewhere.
    """
    _check_tiled(db3, s2t, t, ti, c0, lo, hi)
    if db3.device.type == "cpu":
        return ivf_list_scores_tiled_reference(db3, s2t, t, ti, c0, lo, hi)
    if db3.device.type == "cuda":
        return _ivf_list_scores_tiled_cuda(db3, s2t, t, ti, c0, lo, hi)
    raise ValueError(f"ivf_list_scores_tiled: unsupported device "
                     f"{db3.device}")


def ivf_list_scores_tiled_reference(db3, s2t, t, ti, c0, lo,
                                    hi) -> torch.Tensor:
    """The plain PyTorch version of :func:`ivf_list_scores_tiled`: a gather
    of each live (d, W_TILED) window and an f32 product with ``t``, in
    blocks of live slots under ``REFERENCE_BYTES``; dead slots (``lo ==
    hi``) read nothing and are +inf."""
    _check_tiled(db3, s2t, t, ti, c0, lo, hi)
    b, p = ti.shape
    d = db3.shape[1]
    lane = torch.arange(W_TILED, device=db3.device)
    dims = torch.arange(d, device=db3.device)
    out = torch.full((b, p, W_TILED), math.inf, dtype=torch.float32,
                     device=db3.device)
    qi, pi = torch.nonzero(hi > lo, as_tuple=True)
    s_block = max(1, REFERENCE_BYTES // (4 * W_TILED * d))
    for s0 in range(0, qi.numel(), s_block):
        bq, bp = qi[s0:s0 + s_block], pi[s0:s0 + s_block]
        tt = ti[bq, bp].long()[:, None]                  # (s, 1)
        cols = c0[bq, bp].long()[:, None] + lane          # (s, W)
        u = db3[tt[..., None], dims[:, None], cols[:, None, :]].float()
        ip = (u * t[bq, :, None]).sum(1)                  # (s, W)
        scores = s2t[tt, 0, cols] - 2.0 * ip
        ok = _window_mask(lo[bq, bp], hi[bq, bp], W_TILED, db3.device)
        out[bq, bp] = torch.where(ok, scores, math.inf)
    return out


def _ivf_list_scores_tiled_cuda(db3, s2t, t, ti, c0, lo,
                                hi) -> torch.Tensor:
    """Launch ``csrc/ivf_list_scores_tiled.cu`` on the current stream."""
    n_tiles, d, tile_n = db3.shape
    b, p = ti.shape
    if db3.dtype != torch.int8:
        raise TypeError(f"ivf_list_scores_tiled: the kernel takes int8 "
                        f"codes, not {db3.dtype}")
    for name, x in (("db3", db3), ("s2t", s2t)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"ivf_list_scores_tiled: {name} must be "
                             "contiguous and 16-byte aligned")
    if b * p >= 2 ** 31:
        raise ValueError("ivf_list_scores_tiled: grid exceeds 2^31 blocks")
    t = t.contiguous()
    ti, c0, lo, hi = (x.to(torch.int32).contiguous()
                      for x in (ti, c0, lo, hi))
    out = torch.empty((b, p, W_TILED), dtype=torch.float32,
                      device=db3.device)
    stream = torch.cuda.current_stream(db3.device).cuda_stream
    with torch.cuda.device(db3.device):          # see _kernels.library
        err = _kernels.library().ivf_list_scores_tiled_i8(
            t.data_ptr(), db3.data_ptr(), s2t.data_ptr(), ti.data_ptr(),
            c0.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), b,
            p, d, tile_n, W_TILED, db3.device.index, stream)
    _kernels.check(err, "ivf_list_scores_tiled_i8")
    LAUNCHES["ivf_list_scores_tiled"] += 1
    return out


def _tiled_scan_finish(db3, s2t, a, b_codec, q, q_norm, t, ti, c0, lo, hi,
                       *, k: int, rerank: str = "gather",
                       metric: str = "euclidean"):
    """
    Tail of the tiled query (``pallas_ivf.py:593-691``): K7 over the probe
    windows, the top ``k + 8``, then per ``rerank``:

    - "gather": each winner's 128-row segment through K3, decoded, exact
      f32 distance under ``metric`` (``scan.exact_rerank_decoded``).
    - "score": distances from the surrogate. euclidean:
      ``sqrt(score + ||q - b||^2)``. inner_product: the caller folded
      ``t = q a / 2`` against zeroed stats, so the score is
      ``-<q, x_hat - b>`` and the distance is ``score - <q, b>``. cosine:
      rows and queries are unit vectors, so the angular distance is
      ``2 arccos(1 - d^2 / 2) / pi``.

    Queries run in blocks that keep the (b, P, W_TILED) scores and the
    gathered segments under ``SCORE_BYTES``.
    """
    n_tiles, d, tile_n = db3.shape
    b, n_probe = ti.shape
    kk = min(k + 8, n_probe * W_TILED)
    per_query = 4 * n_probe * W_TILED
    if rerank != "score":
        per_query += kk * d * SEG * db3.element_size()
    q_block = max(1, SCORE_BYTES // per_query)
    out_d, out_r = [], []
    for q0 in range(0, b, q_block):
        q1 = min(q0 + q_block, b)
        scores = ivf_list_scores_tiled(db3, s2t, t[q0:q1], ti[q0:q1],
                                       c0[q0:q1], lo[q0:q1], hi[q0:q1])
        top_s, rows = _window_topk(scores, ti[q0:q1], c0[q0:q1], tile_n, kk)
        qb = q[q0:q1]
        if rerank == "score":
            if metric == "inner_product":
                dists = top_s - (qb * b_codec[None, :]).sum(-1)[:, None]
            else:
                rq = qb - b_codec[None, :]
                d2 = torch.clamp(top_s + (rq * rq).sum(-1)[:, None],
                                 min=0.0)
                if metric == "cosine":
                    sim = torch.clamp(1.0 - d2 / 2.0, -1.0, 1.0)
                    dists = 2.0 * torch.arccos(sim) / math.pi
                else:
                    dists = torch.sqrt(d2)
            dists = torch.where(rows < 0, math.inf, dists)
            dd, rr = pad_to_k(dists, rows, k)
        else:
            rows_c = torch.clamp(rows, min=0)
            blocks = seg_gather_tiled(db3, rows_c // SEG)  # (b, kk, d, 128)
            col = (rows_c % SEG)[:, :, None, None].expand(-1, -1, d, 1)
            x = sq8_decode(torch.gather(blocks, 3, col)[..., 0], a, b_codec)
            dd, rr = exact_rerank_decoded(x, qb, q_norm[q0:q1], top_s, rows,
                                          metric, k)
        out_d.append(dd)
        out_r.append(rr)
    return torch.cat(out_d), torch.cat(out_r)


def _window_topk(scores, ti, c0, tile_n: int, kk: int):
    """The ``kk`` smallest of a (b, P, W_TILED) score block and their
    global rows (window lane w of slot p is row ``ti * tile_n + c0 + w``);
    -1 where the score is +inf."""
    top_s, sel = topk_smallest(scores.reshape(scores.shape[0], -1), kk)
    base = ti.long() * tile_n + c0.long()
    rows = torch.gather(base, 1, sel // W_TILED) + sel % W_TILED
    return top_s, torch.where(torch.isinf(top_s), -1, rows)


def tiled_windows(a: torch.Tensor, b_codec: torch.Tensor,
                  centroids: torch.Tensor, slot_table: torch.Tensor,
                  v_tile: torch.Tensor, v_col: torch.Tensor,
                  v_len: torch.Tensor, q: torch.Tensor, *, nprobe_orig: int,
                  tile_n: int = TILE_ROWS, metric: str = "euclidean"):
    """
    K7's operands for a query batch (``pallas_ivf.py:1120-1140``): the
    query fold ``t``, then the ``nprobe_orig`` nearest original centroids
    expanded to their sublist windows.

    ``metric`` folds the query: euclidean and cosine score
    ``s2 - 2 <(q - b) a, u>``; inner_product passes ``t = q a / 2`` against
    zeroed stats and ranks centroids by ``-<q, c>``. Cosine callers pass
    unit queries over codes of unit rows.

    :return: (t (B, d), ti, c0, lo, hi (B, n_probe)).
    """
    q = q.float()
    if metric == "inner_product":
        t = q * (0.5 * a[None, :])
    else:
        t = (q - b_codec[None, :]) * a[None, :]
    c_scores = centroid_scores(
        q, centroids.float(),
        "inner_product" if metric == "inner_product" else "euclidean")
    _, lists = smallest(c_scores, nprobe_orig)
    ti, c0, lo, hi = _expand_slots(slot_table, lists, v_tile, v_col, v_len,
                                   tile_n)
    return t, ti, c0, lo, hi


def ivf_query_dma_tiled_table(db3: torch.Tensor, s2t: torch.Tensor,
                              a: torch.Tensor, b_codec: torch.Tensor,
                              centroids: torch.Tensor,
                              slot_table: torch.Tensor,
                              v_tile: torch.Tensor, v_col: torch.Tensor,
                              v_len: torch.Tensor, q: torch.Tensor, *,
                              k: int, nprobe_orig: int,
                              rerank: str = "gather",
                              metric: str = "euclidean"):
    """
    Tiled IVF query with original-centroid probe selection
    (``pallas_ivf.ivf_query_dma_tiled_table``, ``:1086-1145``): the
    ``nprobe_orig`` nearest original centroids, each expanded to its
    sublist windows through ``slot_table`` (``tiled_windows``), then K7
    and the finish of ``_tiled_scan_finish``.

    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    """
    q = q.float()
    t, ti, c0, lo, hi = tiled_windows(
        a, b_codec, centroids, slot_table, v_tile, v_col, v_len, q,
        nprobe_orig=nprobe_orig, tile_n=db3.shape[2], metric=metric)
    return _tiled_scan_finish(db3, s2t, a, b_codec, q,
                              torch.sqrt((q * q).sum(-1)), t, ti, c0, lo,
                              hi, k=k, rerank=rerank, metric=metric)


# ---------------------------------------------------------------------------
# K8: PQ codes over tiled windows
# ---------------------------------------------------------------------------

def _check_tiled_pq(db3c, s2t, lut, ti, c0, lo, hi) -> None:
    if db3c.dim() != 3 or db3c.shape[2] < W_TILED or db3c.shape[2] % 128 \
            or db3c.dtype not in (torch.uint8, torch.int8):
        raise ValueError(f"ivf_list_scores_tiled_pq: db3c "
                         f"{tuple(db3c.shape)} {db3c.dtype} must be uint8 "
                         "(n_tiles, M, tile_n), tile_n a multiple of 128 "
                         f"and >= {W_TILED}")
    n_tiles, m_sub, tile_n = db3c.shape
    if tuple(s2t.shape) != (n_tiles, 1, tile_n) \
            or s2t.dtype != torch.float32:
        raise ValueError("ivf_list_scores_tiled_pq: s2t must be (n_tiles, "
                         "1, tile_n) float32")
    if lut.dim() != 2 or lut.shape[1] != m_sub * K_SUB \
            or lut.dtype != torch.float32:
        raise ValueError(f"ivf_list_scores_tiled_pq: lut must be (B, "
                         f"{m_sub * K_SUB}) float32")
    for name, x in (("ti", ti), ("c0", c0), ("lo", lo), ("hi", hi)):
        if x.dim() != 2 or x.shape != ti.shape \
                or x.shape[0] != lut.shape[0]:
            raise ValueError(f"ivf_list_scores_tiled_pq: {name} must be "
                             "(B, P)")
    devices = {x.device for x in (db3c, s2t, lut, ti, c0, lo, hi)}
    if len(devices) != 1:
        raise ValueError(f"ivf_list_scores_tiled_pq: tensors on several "
                         f"devices {sorted(map(str, devices))}")


def ivf_list_scores_tiled_pq(db3c: torch.Tensor, s2t: torch.Tensor,
                             lut: torch.Tensor, ti: torch.Tensor,
                             c0: torch.Tensor, lo: torch.Tensor,
                             hi: torch.Tensor) -> torch.Tensor:
    """
    K8: masked PQ asymmetric-distance scores over tiled windows
    (``pallas_ivf.ivf_list_scores_tiled_pq``, ``:784-836``).

    :param db3c: (n_tiles, M, tile_n) PQ codes, uint8 (or int8 holding
        the uint8 bit pattern, as the JAX package stores them); read as
        unsigned bytes.
    :param s2t: (n_tiles, 1, tile_n) f32 row stats, +inf on dead rows.
    :param lut: (B, M * 256) f32 per-query table
        ``lut[b, m * 256 + v] = <q_m, codebook[m, v]>``.
    :param ti, c0, lo, hi: (B, P) as for :func:`ivf_list_scores_tiled`.
    :return: (B, P, W_TILED) f32 ``s2 - 2 sum_m lut[m, code_m]`` of
        column ``c0 + w`` of tile ``ti`` for ``lo <= w < hi``, +inf
        elsewhere.
    """
    _check_tiled_pq(db3c, s2t, lut, ti, c0, lo, hi)
    if db3c.device.type == "cpu":
        return ivf_list_scores_tiled_pq_reference(db3c, s2t, lut, ti, c0,
                                                  lo, hi)
    if db3c.device.type == "cuda":
        return _ivf_list_scores_tiled_pq_cuda(db3c, s2t, lut, ti, c0, lo,
                                              hi)
    raise ValueError(f"ivf_list_scores_tiled_pq: unsupported device "
                     f"{db3c.device}")


def ivf_list_scores_tiled_pq_reference(db3c, s2t, lut, ti, c0, lo,
                                       hi) -> torch.Tensor:
    """The plain PyTorch version of :func:`ivf_list_scores_tiled_pq`: a
    gather of each live (M, W_TILED) code window and a gather of the table
    at those codes, in blocks of live slots under ``REFERENCE_BYTES``;
    dead slots (``lo == hi``) read nothing and are +inf."""
    _check_tiled_pq(db3c, s2t, lut, ti, c0, lo, hi)
    b, p = ti.shape
    m_sub = db3c.shape[1]
    dev = db3c.device
    lane = torch.arange(W_TILED, device=dev)
    subs = torch.arange(m_sub, device=dev)
    out = torch.full((b, p, W_TILED), math.inf, dtype=torch.float32,
                     device=dev)
    qi, pi = torch.nonzero(hi > lo, as_tuple=True)
    s_block = max(1, REFERENCE_BYTES // (8 * W_TILED * m_sub))
    for s0 in range(0, qi.numel(), s_block):
        bq, bp = qi[s0:s0 + s_block], pi[s0:s0 + s_block]
        tt = ti[bq, bp].long()[:, None]                  # (s, 1)
        cols = c0[bq, bp].long()[:, None] + lane          # (s, W)
        codes = db3c[tt[..., None], subs[:, None], cols[:, None, :]]
        idx = subs[:, None] * K_SUB + (codes.long() & 0xFF)   # (s, M, W)
        ip = torch.gather(lut[bq], 1, idx.reshape(idx.shape[0], -1)) \
            .view(idx.shape).sum(1)                       # (s, W)
        scores = s2t[tt, 0, cols] - 2.0 * ip
        ok = _window_mask(lo[bq, bp], hi[bq, bp], W_TILED, dev)
        out[bq, bp] = torch.where(ok, scores, math.inf)
    return out


def _ivf_list_scores_tiled_pq_cuda(db3c, s2t, lut, ti, c0, lo,
                                   hi) -> torch.Tensor:
    """Launch ``csrc/ivf_list_scores_tiled_pq.cu`` on the current
    stream."""
    n_tiles, m_sub, tile_n = db3c.shape
    b, p = ti.shape
    db3c = db3c.view(torch.uint8)
    lut = lut.contiguous()
    for name, x in (("db3c", db3c), ("s2t", s2t), ("lut", lut)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"ivf_list_scores_tiled_pq: {name} must be "
                             "contiguous and 16-byte aligned")
    if b >= 2 ** 31 or p >= 2 ** 31:
        raise ValueError("ivf_list_scores_tiled_pq: 2^31 queries or slots "
                         "a query, or more")
    ti, c0, lo, hi = (x.to(torch.int32).contiguous()
                      for x in (ti, c0, lo, hi))
    out = torch.empty((b, p, W_TILED), dtype=torch.float32,
                      device=db3c.device)
    stream = torch.cuda.current_stream(db3c.device).cuda_stream
    with torch.cuda.device(db3c.device):         # see _kernels.library
        err = _kernels.library().ivf_list_scores_tiled_pq(
            lut.data_ptr(), db3c.data_ptr(), s2t.data_ptr(), ti.data_ptr(),
            c0.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(), b,
            p, m_sub, tile_n, W_TILED, db3c.device.index, stream)
    _kernels.check(err, "ivf_list_scores_tiled_pq")
    LAUNCHES["ivf_list_scores_tiled_pq"] += 1
    return out


def pq_lut(q_c: torch.Tensor, codebooks: torch.Tensor) -> torch.Tensor:
    """(B, M * 256) f32 ADC table ``<q_m, codebook[m, v]>`` of codec-grid
    queries (``pallas_ivf.py:1033-1036``), in full f32."""
    b = q_c.shape[0]
    m_sub, k_sub, dsub = codebooks.shape
    require_full_f32(q_c)
    lut = torch.einsum("bms,mvs->bmv", q_c.reshape(b, m_sub, dsub),
                       codebooks.float())
    return lut.reshape(b, m_sub * k_sub).contiguous()


def _tiled_scan_finish_pq(db3c, s2t, codebooks, q_c, lut, ti, c0, lo, hi,
                          *, k: int, rerank: str = "gather", probe_off=None,
                          res_cents=None, row2list=None,
                          metric: str = "euclidean"):
    """
    Tail of the tiled PQ query (``pallas_ivf.py:839-930``): K8 over the
    probe windows, residual PQ's per-probe offset (+inf windows stay
    +inf), the top ``k + 8``, then per ``rerank``:

    - "gather": each winner's codes through K3, decoded exactly (plus its
      list's codec-space centroid in residual mode), exact f32 distance
      under ``metric`` on the codec grid;
    - "score": the surrogate. euclidean: ``sqrt(score + ||q||^2)``;
      inner_product (zeroed stats): ``score / 2``; cosine (unit rows and
      queries): ``2 arccos(1 - d^2 / 2) / pi``.

    Queries run in blocks that keep the (b, P, W_TILED) scores and the
    gathered segments under ``SCORE_BYTES``.
    """
    n_tiles, m_sub, tile_n = db3c.shape
    b, n_probe = ti.shape
    q_sq = (q_c * q_c).sum(-1)
    q_norm = torch.sqrt(q_sq)
    kk = min(k + 8, n_probe * W_TILED)
    per_query = 4 * n_probe * W_TILED
    if rerank != "score":
        per_query += kk * m_sub * SEG
    q_block = max(1, SCORE_BYTES // per_query)
    out_d, out_r = [], []
    for q0 in range(0, b, q_block):
        q1 = min(q0 + q_block, b)
        scores = ivf_list_scores_tiled_pq(db3c, s2t, lut[q0:q1], ti[q0:q1],
                                          c0[q0:q1], lo[q0:q1], hi[q0:q1])
        if probe_off is not None:
            scores = scores + probe_off[q0:q1, :, None]
        top_s, rows = _window_topk(scores, ti[q0:q1], c0[q0:q1], tile_n, kk)
        if rerank == "score":
            if metric == "inner_product":
                dists = top_s / 2.0
            else:
                d2 = torch.clamp(top_s + q_sq[q0:q1, None], min=0.0)
                if metric == "cosine":
                    sim = torch.clamp(1.0 - d2 / 2.0, -1.0, 1.0)
                    dists = 2.0 * torch.arccos(sim) / math.pi
                else:
                    dists = torch.sqrt(d2)
            dists = torch.where(rows < 0, math.inf, dists)
            dd, rr = pad_to_k(dists, rows, k)
        else:
            rows_c = torch.clamp(rows, min=0)
            blocks = seg_gather_tiled(db3c, rows_c // SEG)  # (b, kk, M, 128)
            col = (rows_c % SEG)[:, :, None, None].expand(-1, -1, m_sub, 1)
            x = _dequant(torch.gather(blocks, 3, col)[..., 0], codebooks)
            if res_cents is not None:
                x = x + res_cents[row2list[rows_c].long()]
            dd, rr = exact_rerank_decoded(x, q_c[q0:q1], q_norm[q0:q1],
                                          top_s, rows, metric, k)
        out_d.append(dd)
        out_r.append(rr)
    return torch.cat(out_d), torch.cat(out_r)


def tiled_windows_pq(codebooks: torch.Tensor, transform: torch.Tensor,
                     centroids: torch.Tensor, slot_table: torch.Tensor,
                     v_tile: torch.Tensor, v_col: torch.Tensor,
                     v_len: torch.Tensor, q: torch.Tensor, *,
                     nprobe_orig: int, tile_n: int = TILE_ROWS,
                     metric: str = "euclidean", residual: bool = False):
    """
    K8's operands for a query batch (``pallas_ivf.py:1018-1057``): the
    codec-grid queries and their ADC tables, then the ``nprobe_orig``
    nearest original centroids (by ``-<q, c>`` for inner_product, L2
    otherwise) expanded to their sublist windows. In residual mode each
    slot also gets its list's ``-2 <q, c>`` (zero on padding slots).

    :param transform: (d_codec,) dim interleave or (d_codec, d_codec) OPQ
        matrix (``ops/pq.pq_transform_queries``).
    :return: (q_c (B, d_codec), lut (B, M * 256), ti, c0, lo, hi
        (B, n_probe), probe_off (B, n_probe) or None).
    """
    q = q.float()
    q_c = pq_transform_queries(q, transform)
    lut = pq_lut(q_c, codebooks)
    require_full_f32(q)
    c = centroids.float()
    ip_c = q @ c.T
    c_scores = -ip_c if metric == "inner_product" \
        else (c * c).sum(-1)[None, :] - 2.0 * ip_c
    _, lists = smallest(c_scores, nprobe_orig)
    ti, c0, lo, hi = _expand_slots(slot_table, lists, v_tile, v_col, v_len,
                                   tile_n)
    probe_off = None
    if residual:
        # Per original list, repeated over its S_max sublist slots, then
        # zero over the budget padding (its windows are empty).
        off = (-2.0 * torch.gather(ip_c, 1, lists)).repeat_interleave(
            slot_table.shape[1], dim=1)
        probe_off = torch.cat(
            [off, off.new_zeros((off.shape[0], ti.shape[1] - off.shape[1]))],
            dim=1)
    return q_c, lut, ti, c0, lo, hi, probe_off


def ivf_query_dma_tiled_table_pq(db3c: torch.Tensor, s2t: torch.Tensor,
                                 codebooks: torch.Tensor,
                                 transform: torch.Tensor,
                                 centroids: torch.Tensor,
                                 slot_table: torch.Tensor,
                                 v_tile: torch.Tensor, v_col: torch.Tensor,
                                 v_len: torch.Tensor, q: torch.Tensor, *,
                                 k: int, nprobe_orig: int,
                                 rerank: str = "gather", res_cents=None,
                                 row2list=None, metric: str = "euclidean"):
    """
    Tiled IVF-PQ query with original-centroid probe selection
    (``pallas_ivf.ivf_query_dma_tiled_table_pq``, ``:966-1065``): probe
    selection in the original dim order, the ADC table and the exact
    decode on the codec grid (distances are invariant under the
    interleave and the orthogonal OPQ rotation).

    :param transform: (d_codec,) dim interleave, or the (d_codec, d_codec)
        OPQ interleave-and-rotation matrix.
    :param q: (B, d_pad) f32 queries, original (padded) order; cosine
        callers pass unit queries over codes of unit rows.
    :param res_cents: (C, d_codec) f32 codec-space centroids: residual
        mode (codes carry ``x_T - c_T[list]``, s2t holds
        ``||c_T + r_hat||^2``). Residual inner_product is rejected.
    :param row2list: (n_pad,) list of each tiled row (residual gather).
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    """
    if res_cents is not None and rerank != "score" and row2list is None:
        raise ValueError("residual gather re-rank needs row2list")
    if res_cents is not None and metric == "inner_product":
        raise ValueError(
            "residual PQ serves euclidean or cosine (IP probe selection "
            "has no L2 -2<q,c> decomposition)")
    q_c, lut, ti, c0, lo, hi, probe_off = tiled_windows_pq(
        codebooks, transform, centroids, slot_table, v_tile, v_col, v_len,
        q, nprobe_orig=nprobe_orig, tile_n=db3c.shape[2], metric=metric,
        residual=res_cents is not None)
    return _tiled_scan_finish_pq(db3c, s2t, codebooks, q_c, lut, ti, c0, lo,
                                 hi, k=k, rerank=rerank,
                                 probe_off=probe_off, res_cents=res_cents,
                                 row2list=row2list, metric=metric)
