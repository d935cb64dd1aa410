"""
Exact exhaustive top-k through a fused stage-1 kernel and an exact
stage-2 re-rank: the PyTorch counterpart of
``smqtk_indexing_tpu/ops/pallas_scan.py`` (named for what it does, since
there is no Pallas here).

Stage 1, ``segment_minima``: per query, the minimum of the L2 surrogate
``||x||^2 - 2<q,x> + penalty`` over every 128-row segment, so the (B, N)
score matrix never reaches memory. On a CUDA tensor it runs a
hand-written Hopper kernel (the port of ``pallas_scan.segment_minima`` ->
``_scan_kernel``, ``:102-241``); on a CPU tensor, its plain PyTorch
version ``segment_minima_reference``. The database is f32, bf16 or int8;
the int8 form is the flat SQ8 store's stage 1 over its row-major codes
(``ops/sq8.sq8_topk``). An f32 database takes ``precision``, the TPU
kernel's stage-1 dot mode (``pallas_scan.PRECISIONS``; the flat store
passes ``ops/device.stage1_precision()``, ``SMQTK_TPU_STAGE1``):
``split3`` (the default) splits both operands into bf16 hi and lo parts
and sums three bf16 products, ``hi.hi + hi.lo + lo.hi``, and ``native``
takes the one product ``hi.hi``, both on the tensor cores
(``csrc/segment_minima_wgmma.cu``, forms ``wgmma_split3`` and
``wgmma_native``); ``highest`` runs ``csrc/segment_minima.cu``, exact f32
FFMA on the CUDA cores (form ``ffma``). A bf16 database or int8 codes run
``csrc/segment_minima_wgmma.cu`` on the tensor cores (``wgmma``, bf16 x
bf16 -> f32) with the query rounded to bf16, as the TPU kernel runs them
on its matrix unit, whatever ``precision`` says: every product of a bf16
value with a bf16 value or an int8 code is exact, and only the order and
rounding of the f32 sums differ from the plain version.

Every stage-1 function here also takes an int8 query over an int8
database: the ``i8dot`` int8 x int8 form (``pallas_scan._tile_ip``,
``:53-61``; the caller quantised the query with one scale and divided the
row stats by it, ``ops/sq8._i8dot_q``). The products are summed exactly
(``wgmma`` s8 x s8 -> s32 on the card's tensor cores, in
``csrc/segment_minima_wgmma.cu`` and ``csrc/segment_minima_tiled_wgmma.cu``;
f32 in the plain versions, where every partial sum is an integer below
2^24 at d <= 1040), then the same f32 epilogue ``(db_sq - 2 ip) +
penalty`` applies, so the kernels and the plain versions agree bit for
bit. :data:`LAUNCHES` counts each wrapper's launches by the form its
kernel took, so a run shows which form stage 1 took.

Stage 2 (``pallas_scan.py:619-700``, the f32 form): the top ``s_keep``
segments by minimum, a gather of their rows, exact per-metric distances
in the difference form, and the final top-k. Exactness of the
pre-selection: every row of the true top-k scores <= theta (the k-th
best), so its segment's minimum is <= theta; at most k distinct segment
minima can be <= theta, so the best ``k + 8`` segments hold every true
top-k row, with slack for ties.

The bf16 ``db_seg_lo`` stage-2 form (``pallas_scan.py:702-755``) is not
ported: the store never takes it.

``seg_gather_tiled`` is the port of ``pallas_scan._seg_gather_tiled``
(``:393-454``): it gathers (d, 128) segments of the tiled-transposed
layout, for the IVF code tier's exact re-rank (``ops/ivf_scan.py``) and
the capacity scan's stage 2 (``ops/sq8.sq8_topk_blocked``). On a CUDA
tensor it runs ``csrc/seg_gather.cu``; on a CPU tensor, its plain version.

Stage 1 over the single-copy layouts of the capacity scan
(``ops/sq8.sq8_topk_blocked``); over int8 codes all three run
``csrc/segment_minima_tiled_wgmma.cu`` on the tensor cores, with the query
rounded to bf16 (``wgmma``, the capacity scan's own form) or as an int8
query (``wgmma_s8``, the int8 x int8 form), and over an f32 or bf16
database f32 FFMA (``csrc/segment_minima_tiled.cu``,
``csrc/tiled_minima.cuh``):

- ``segment_minima_tiled`` (K2, ``pallas_scan.py:244-310``) over the tiled
  layout (n_tiles, d, tile_n) built by :func:`tiled_layout`: K1's minima,
  (B, N / 128);
- ``segment_minima_blocked`` (K4, ``:490-544``) over the blocked layout
  (N / 128, d, 128) built by :func:`blocked_layout`, the tiled layout with
  tile_n = 128;
- ``segment_minima_tiled2`` (K5, ``:805-870``): K2's minima step-major,
  with per-group minima for :func:`topk_segments_stepmajor`.

The JAX package pins ``tile_n == TILE_N`` (``TILE_N // 2`` in its TPU
split3 mode); the port takes any ``tile_n % 128 == 0`` and works out the
step and group widths from the ``tile_n`` it is given.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from smqtk_indexing_tpu_torch.ops import _kernels
from smqtk_indexing_tpu_torch.ops.device import (
    PRECISIONS, require_full_f32,
)
from smqtk_indexing_tpu_torch.utils.tracing import trace_span

#: Segment width: rows collapsing to one stage-1 output element.
SEG = 128

#: Rows per tile of the single-copy tiled layout (``pallas_scan.TILE_N``).
TILE_N = 4096

#: Tiles per step of ``segment_minima_tiled2``'s step-major output, halved
#: until it divides the tile count (``pallas_scan.py:827-829``).
TILES_PER_STEP = 8

#: Metrics with a matmul-form surrogate, served by this path.
FUSED_METRICS = ("euclidean", "inner_product", "cosine")

#: The stage-1 kernel's C entry point for a bf16 database and int8 codes
#: under a float query.
_STAGE1_ENTRY = {torch.bfloat16: "segment_minima_bf16",
                 torch.int8: "segment_minima_i8"}

#: The f32 stage-1 kernel's C entry point for each precision.
_F32_ENTRY = {"highest": "segment_minima_f32",
              "split3": "segment_minima_f32_split3",
              "native": "segment_minima_f32_native"}

#: Each database dtype's suffix of the tiled kernels' C entry points.
_TILED_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16",
                 torch.int8: "i8"}

#: The form of the kernel each stage-1 C entry point launches, by the
#: source that defines it and the instruction its products run on: ``ffma``
#: (``segment_minima.cu``, ``segment_minima_tiled.cu``), ``wgmma`` (a bf16
#: query on the tensor cores), ``wgmma_s8`` (an int8 query on the tensor
#: cores; both ``segment_minima_wgmma.cu``,
#: ``segment_minima_tiled_wgmma.cu``, K9's variants included), or
#: ``wgmma_split3`` and ``wgmma_native`` (an f32 database split to bf16 on
#: the tensor cores, ``segment_minima_wgmma.cu``). The launchers choose the
#: entry point, take its form from here and give the query in the form's
#: operand type.
_ENTRY_FORM = {
    "segment_minima_f32": "ffma", "segment_minima_bf16": "wgmma",
    "segment_minima_i8": "wgmma", "segment_minima_i8i8": "wgmma_s8",
    "segment_minima_f32_split3": "wgmma_split3",
    "segment_minima_f32_native": "wgmma_native",
    **{f"{entry}_{suffix}": form
       for entry in ("segment_minima_tiled", "segment_minima_tiled2")
       for suffix, form in (("f32", "ffma"), ("bf16", "ffma"),
                            ("i8", "wgmma"), ("i8i8", "wgmma_s8"))},
    "stage1_variant_i8": "wgmma", "stage1_variant_i8i8": "wgmma_s8"}

#: The stage-1 wrappers: K1, K2, K4, K5.
_STAGE1_WRAPPERS = ("segment_minima", "segment_minima_tiled",
                    "segment_minima_blocked", "segment_minima_tiled2")

#: Launches of this module's CUDA kernels in this process, by (wrapper,
#: form). A stage-1 wrapper's form is ``ffma`` (f32 FFMA on the CUDA
#: cores), ``wgmma`` (bf16 products on the tensor cores) or ``wgmma_s8``
#: (an int8 query over int8 codes, s8 products on the tensor cores); K1's
#: also ``wgmma_split3`` or ``wgmma_native`` (an f32 database split to
#: bf16 on the tensor cores); ``seg_gather_tiled``'s is ``copy``. Each
#: wrapper adds one where it launches its kernel and nowhere else.
LAUNCHES = {**{(w, f): 0 for w in _STAGE1_WRAPPERS
               for f in ("ffma", "wgmma", "wgmma_s8")},
            ("segment_minima", "wgmma_split3"): 0,
            ("segment_minima", "wgmma_native"): 0,
            ("seg_gather_tiled", "copy"): 0}

#: Cap on the (B, C) f32 score block of ``segment_minima_reference``.
REFERENCE_BYTES = 1 << 28

#: Cap on stage 2's (b, s_keep * 128, d) f32 candidate block: queries run
#: in blocks under it (eager PyTorch materialises the gather XLA fused).
STAGE2_BYTES = 1 << 28


def _q_kernel_dtype(q: torch.Tensor, db_dtype: torch.dtype) -> torch.Tensor:
    """Stage-1 query operand of the plain versions
    (``pallas_scan._q_kernel_dtype``, ``:85-99``): an int8 query as it is
    (the int8 x int8 form), else f32, rounded to bf16 first for a bf16 or
    int8 database, so that every product of a bf16 value with a bf16 value
    or an int8 code is exact in f32. The kernels of those two forms take
    the same rounded query as a bf16 tensor (:func:`_segment_minima_cuda`).

    :raises ValueError: an int8 query over a database that is not int8.
    """
    if q.dtype == torch.int8:
        if db_dtype != torch.int8:
            raise ValueError("int8 queries require an int8 (SQ8-coded) "
                             f"database; got db dtype {db_dtype}")
        return q
    if db_dtype in (torch.bfloat16, torch.int8):
        return q.to(torch.bfloat16).float()
    return q.float()


def _check_query(q: torch.Tensor, db_dtype: torch.dtype, name: str) -> None:
    """The query is f32, or int8 over an int8 database."""
    if q.dtype not in (torch.float32, torch.int8):
        raise TypeError(f"{name}: q must be float32 (or int8 over int8 "
                        f"codes), not {q.dtype}")
    _q_kernel_dtype(q[:0], db_dtype)


def split_bf16(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``split3`` parts of an f32 tensor (``pallas_scan._tile_ip``,
    ``:65-68``): ``hi = bf16(x)`` and ``lo = bf16(x - f32(hi))``, each
    rounded to nearest even as ``jnp.astype`` rounds, as bf16 tensors."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _query_operand(q: torch.Tensor, db_dtype: torch.dtype,
                   form: str) -> torch.Tensor:
    """The query as the kernel of ``form`` reads it: the bf16-rounded
    query of :func:`_q_kernel_dtype` as a bf16 tensor for ``wgmma`` (and
    the hi part for ``wgmma_native``), its hi and lo parts stacked (2, B,
    d) for ``wgmma_split3``, else that function's f32 (or int8) query;
    contiguous."""
    if form in ("wgmma", "wgmma_native"):
        return q.to(torch.bfloat16).contiguous()
    if form == "wgmma_split3":
        return torch.stack(split_bf16(q.float()))
    return _q_kernel_dtype(q, db_dtype).contiguous()


def _check_stage1(db, db_sq, penalty, q, precision) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"segment_minima: precision {precision!r} is not "
                         f"one of {PRECISIONS}")
    if db.dim() != 2 or q.dim() != 2 or q.shape[1] != db.shape[1]:
        raise ValueError(
            f"segment_minima: db {tuple(db.shape)} and q {tuple(q.shape)} "
            "must be (N, d) and (B, d)")
    n = db.shape[0]
    if n % SEG:
        raise ValueError(f"segment_minima: N={n} is not a multiple of {SEG}")
    if db_sq.shape != (n,) or penalty.shape != (n,):
        raise ValueError("segment_minima: db_sq and penalty must be (N,)")
    if db.dtype not in (torch.float32, *_STAGE1_ENTRY):
        raise TypeError(f"segment_minima: db dtype {db.dtype} is not "
                        "float32, bfloat16 or int8")
    if (db_sq.dtype, penalty.dtype) != (torch.float32,) * 2:
        raise TypeError("segment_minima: db_sq and penalty must be float32")
    _check_query(q, db.dtype, "segment_minima")


def segment_minima(db: torch.Tensor, db_sq: torch.Tensor,
                   penalty: torch.Tensor, q: torch.Tensor,
                   precision: str = "split3") -> torch.Tensor:
    """
    Stage 1: per-query, per-128-row-segment minima of the L2 surrogate.

    :param db: (N, d) row-major database, f32, bf16 or int8 (SQ8 codes),
        N % 128 == 0.
    :param db_sq: (N,) f32 squared norms (zeros for inner_product/cosine;
        ``sum((a u)^2)`` for SQ8 codes).
    :param penalty: (N,) f32, 0 for live rows and +inf for dead ones.
    :param q: (B, d) f32 queries, or the SQ8 fold ``(q - b) a`` (rounded
        to bf16 for a bf16 or int8 database), or that fold quantised to
        int8 over int8 codes (the int8 x int8 form).
    :param precision: the f32 database's stage-1 dot mode, one of
        ``PRECISIONS`` (``pallas_scan.segment_minima``'s): ``split3``,
        ``native`` or ``highest``. A bf16 database and int8 codes ignore
        it, as the TPU kernel runs them "native".
    :return: (B, N // 128) f32 segment minima.
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built
        or launched. There is no fallback to the plain version.
    """
    devices = {t.device for t in (db, db_sq, penalty, q)}
    if len(devices) != 1:
        raise ValueError(f"segment_minima: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return segment_minima_reference(db, db_sq, penalty, q, precision)
    if dev.type == "cuda":
        return _segment_minima_cuda(db, db_sq, penalty, q, precision)
    raise ValueError(f"segment_minima: unsupported device {dev}")


def segment_minima_reference(db: torch.Tensor, db_sq: torch.Tensor,
                             penalty: torch.Tensor, q: torch.Tensor,
                             precision: str = "split3") -> torch.Tensor:
    """The plain PyTorch version of :func:`segment_minima`, on any device:
    row chunks of f32 scores, each reduced to its segment minima at once,
    so it never holds more than ``REFERENCE_BYTES`` of scores. An f32
    database's ``split3`` sums three f32 products of the bf16 parts of
    :func:`split_bf16` in the JAX order (``ip = hh; ip += hl; ip += lh``),
    ``native`` takes ``hh`` alone (each product of two bf16 values is exact
    in f32), and ``highest`` one f32 product. On a card the caller keeps
    TF32 products off (``require_full_f32``)."""
    _check_stage1(db, db_sq, penalty, q, precision)
    n = db.shape[0]
    b = q.shape[0]
    # Only an f32 database under a float query is split.
    split = precision != "highest" and db.dtype == torch.float32 \
        and q.dtype != torch.int8
    # An int8 query's products are integers below 2^24: exact in f32.
    qk = _q_kernel_dtype(q, db.dtype).float()
    require_full_f32(qk)
    if split:
        qh, ql = (p.float() for p in split_bf16(qk))
    out = torch.empty((b, n // SEG), dtype=torch.float32, device=db.device)
    rows = max(SEG, REFERENCE_BYTES // (4 * max(b, 1)) // SEG * SEG)
    for lo in range(0, n, rows):
        hi = min(lo + rows, n)
        if not split:
            ip = qk @ db[lo:hi].float().T
        else:
            xh, xl = (p.float() for p in split_bf16(db[lo:hi]))
            ip = qh @ xh.T
            if precision == "split3":
                ip += qh @ xl.T
                ip += ql @ xh.T
        s = (db_sq[lo:hi] - 2.0 * ip) + penalty[lo:hi]
        out[:, lo // SEG:hi // SEG] = s.view(b, -1, SEG).amin(dim=-1)
    return out


def _segment_minima_cuda(db, db_sq, penalty, q,
                         precision: str = "split3") -> torch.Tensor:
    """Launch ``csrc/segment_minima.cu`` (f32 database, ``highest``) or
    ``csrc/segment_minima_wgmma.cu`` (f32 database, ``split3`` or
    ``native``; bf16 database or int8 codes, with the query as bf16; int8
    x int8) on the current stream."""
    _check_stage1(db, db_sq, penalty, q, precision)
    n, d = db.shape
    b = q.shape[0]
    # The int8 x int8 form zero-fills a K-chunk's tail, a k32 step at a
    # time; the others take whole 128-dim chunks.
    depth = 32 if q.dtype == torch.int8 else 128
    if d % depth:
        raise ValueError(f"segment_minima: d={d} is not a multiple of "
                         f"{depth} (stores pad it with pad_dim)")
    if q.dtype == torch.int8:
        name = "segment_minima_i8i8"
    elif db.dtype == torch.float32:
        name = _F32_ENTRY[precision]
    else:
        name = _STAGE1_ENTRY[db.dtype]
    form = _ENTRY_FORM[name]
    qk = _query_operand(q, db.dtype, form)
    for what, t in (("db", db), ("db_sq", db_sq), ("penalty", penalty)):
        if not t.is_contiguous():
            raise ValueError(f"segment_minima: {what} is not contiguous")
    if any(t.data_ptr() % 16 for t in (db, qk, db_sq, penalty)):
        raise ValueError("segment_minima: db, q, db_sq and penalty must be "
                         "16-byte aligned")
    if -(-b // 128) * (n // SEG) >= 2 ** 31:
        raise ValueError("segment_minima: grid exceeds 2^31 blocks")
    out = torch.empty((b, n // SEG), dtype=torch.float32, device=db.device)
    lib = _kernels.library()
    stream = torch.cuda.current_stream(db.device).cuda_stream
    with torch.cuda.device(db.device):           # see _kernels.library
        err = getattr(lib, name)(
            qk.data_ptr(), db.data_ptr(), db_sq.data_ptr(),
            penalty.data_ptr(), out.data_ptr(), b, n, d, db.device.index,
            stream)
    _kernels.check(err, name)
    LAUNCHES["segment_minima", form] += 1
    return out


def _check_gather(db3: torch.Tensor, sid: torch.Tensor) -> None:
    if db3.dim() != 3 or db3.shape[2] % SEG:
        raise ValueError(f"seg_gather_tiled: db3 {tuple(db3.shape)} must be "
                         f"(n_tiles, d, tile_n) with tile_n % {SEG} == 0")
    if sid.dim() != 2 or sid.dtype not in (torch.int32, torch.int64):
        raise ValueError("seg_gather_tiled: sid must be (B, s_keep) int32 "
                         "or int64")
    if sid.device != db3.device:
        raise ValueError(f"seg_gather_tiled: tensors on several devices "
                         f"{db3.device}, {sid.device}")


def seg_gather_tiled(db3: torch.Tensor, sid: torch.Tensor) -> torch.Tensor:
    """
    Gather (d, 128) column slices of the tiled-transposed layout by global
    segment id (``pallas_scan._seg_gather_tiled``, ``:405-454``): segment
    ``s`` is ``db3[s // (tile_n / 128), :, (s % (tile_n / 128)) * 128 :][:,
    :128]``.

    :param db3: (n_tiles, d, tile_n) tensor of any dtype, tile_n % 128 == 0.
    :param sid: (B, s_keep) global segment ids, each in
        ``[0, n_tiles * tile_n / 128)`` (callers clamp empty slots to 0).
    :return: (B, s_keep, d, 128) gathered blocks, in ``db3``'s dtype. On a
        CUDA tensor it runs ``csrc/seg_gather.cu`` (a copy, bit-equal to
        the plain version); on a CPU tensor, ``seg_gather_tiled_reference``.
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built or
        launched. There is no fallback to the plain version.
    """
    _check_gather(db3, sid)
    if db3.device.type == "cpu":
        return seg_gather_tiled_reference(db3, sid)
    if db3.device.type == "cuda":
        return _seg_gather_cuda(db3, sid)
    raise ValueError(f"seg_gather_tiled: unsupported device {db3.device}")


def seg_gather_tiled_reference(db3: torch.Tensor,
                               sid: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`seg_gather_tiled`: advanced
    indexing over the tile axis and a 128-column window per segment."""
    _check_gather(db3, sid)
    n_tiles, d, tile_n = db3.shape
    flat = sid.reshape(-1).long()
    nseg_t = tile_n // SEG
    ti = flat // nseg_t
    cols = (flat % nseg_t)[:, None] * SEG \
        + torch.arange(SEG, device=db3.device)
    # (M, d, 128): tile ti, every dim, the segment's 128 columns.
    out = db3[ti[:, None, None],
              torch.arange(d, device=db3.device)[None, :, None],
              cols[:, None, :]]
    return out.reshape(*sid.shape, d, SEG)


def _seg_gather_cuda(db3: torch.Tensor, sid: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/seg_gather.cu`` on the current stream."""
    if not db3.is_contiguous():
        raise ValueError("seg_gather_tiled: db3 is not contiguous")
    esize = db3.element_size()
    if esize not in (1, 2, 4):
        raise TypeError(f"seg_gather_tiled: {db3.dtype} is not a 1, 2 or "
                        "4-byte type")
    n_tiles, d, tile_n = db3.shape
    flat = sid.reshape(-1).to(torch.int64).contiguous()
    out = torch.empty((flat.shape[0], d, SEG), dtype=db3.dtype,
                      device=db3.device)
    if db3.data_ptr() % 16:
        raise ValueError("seg_gather_tiled: db3 must be 16-byte aligned")
    lib = _kernels.library()
    stream = torch.cuda.current_stream(db3.device).cuda_stream
    with torch.cuda.device(db3.device):          # see _kernels.library
        err = lib.seg_gather_tiled(db3.data_ptr(), flat.data_ptr(),
                                   out.data_ptr(), flat.shape[0], d, tile_n,
                                   esize, db3.device.index, stream)
    _kernels.check(err, "seg_gather_tiled")
    LAUNCHES["seg_gather_tiled", "copy"] += 1
    return out.reshape(*sid.shape, d, SEG)


def topk_smallest(m: torch.Tensor, kk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-``kk`` smallest over the rows of (B, W)
    (``pallas_scan.topk_smallest``, ``:547-574``).

    :return: (values ascending, int64 indices), each (B, kk).
    """
    return torch.topk(m, kk, dim=1, largest=False, sorted=True)


def segments_kept(k: int, n: int) -> int:
    """Segments stage 2 re-ranks for top-``k`` over ``n`` rows. Exactness
    needs only k - 1 segments; +8 absorbs ties at the k-th score."""
    return min(max(k + 8, 16), n // SEG)


def select_segments(minima: torch.Tensor, s_keep: int) -> torch.Tensor:
    """(B, s_keep) ids of the segments with the smallest minima; -1 where
    the minimum is +inf (no live row)."""
    smin, sid = topk_smallest(minima, s_keep)
    return torch.where(torch.isinf(smin), -1, sid)


def normalized_rows(db: torch.Tensor, db_norm: torch.Tensor,
                    dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Row-normalised copy of ``db`` (zero rows stay zero), in ``dtype``
    (default f32): cosine's stage-1 matrix."""
    nrm = torch.where(db_norm == 0, 1.0, db_norm)
    return (db.float() / nrm[:, None]).to(dtype or torch.float32)


def exact_dists(metric: str, cand: torch.Tensor, q: torch.Tensor,
                 q_norm: torch.Tensor, cn: Optional[torch.Tensor]
                 ) -> torch.Tensor:
    """Exact distances of (b, M, d) f32 candidates to (b, d) queries.
    ``cand`` is a fresh gather and is overwritten (euclidean)."""
    if metric == "euclidean":
        # Difference form: ||x||^2 - 2<q,x> + ||q||^2 cancels at tiny
        # distances (ops/scan.py:238-241).
        diff2 = cand.sub_(q[:, None, :]).square_()
        return torch.sqrt(torch.clamp(diff2.sum(-1), min=0.0))
    # Elementwise product and sum, as pallas_scan.py:671-674: full f32
    # without a cuBLAS precision switch.
    ip = cand.mul_(q[:, None, :]).sum(-1)
    if metric == "inner_product":
        return -ip
    denom = q_norm[:, None] * cn
    sim = torch.clamp(ip / torch.where(denom == 0, 1.0, denom), -1.0, 1.0)
    return 2.0 * torch.arccos(sim) / math.pi


def rerank_segments(db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                    sid: torch.Tensor, *, k: int, metric: str = "euclidean",
                    db_norm: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Stage 2: gather the kept segments' rows, exact distances, final top-k.
    Runs over blocks of queries so that the (b, s_keep * 128, d) f32
    candidate block stays under ``STAGE2_BYTES``.

    :param sid: (B, s_keep) segment ids from :func:`select_segments`.
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pad).
    """
    n, d = db.shape
    b, s_keep = sid.shape
    m = s_keep * SEG
    q = q.float()
    q_norm = torch.sqrt((q * q).sum(-1))
    q_block = max(1, STAGE2_BYTES // (4 * m * d))
    db_seg = db.view(n // SEG, SEG, d)
    valid_seg = valid.view(n // SEG, SEG)
    norm_seg = db_norm.view(n // SEG, SEG) if metric == "cosine" else None
    lane = torch.arange(SEG, device=db.device)
    out_d, out_r = [], []
    for lo in range(0, b, q_block):
        hi = min(lo + q_block, b)
        sb = sid[lo:hi]
        sc = torch.clamp(sb, min=0)
        rows = (sc[..., None] * SEG + lane).reshape(hi - lo, m)
        alive = ((sb[..., None] >= 0) & valid_seg[sc]).reshape(hi - lo, m)
        cand = db_seg[sc].reshape(hi - lo, m, d).float()
        cn = norm_seg[sc].reshape(hi - lo, m) if norm_seg is not None \
            else None
        exact = exact_dists(metric, cand, q[lo:hi], q_norm[lo:hi], cn)
        exact = torch.where(alive, exact, math.inf)
        dd, sel = topk_smallest(exact, k)
        rr = torch.gather(rows, 1, sel)
        out_d.append(dd)
        out_r.append(torch.where(torch.isinf(dd), -1, rr))
    return torch.cat(out_d), torch.cat(out_r)


def flat_topk_fused(db: torch.Tensor, db_sq: torch.Tensor,
                    valid: torch.Tensor, q: torch.Tensor, *, k: int,
                    metric: str = "euclidean",
                    db_mirror: Optional[torch.Tensor] = None,
                    db_norm: Optional[torch.Tensor] = None,
                    precision: str = "split3"
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Exact exhaustive top-k: fused stage 1 + exact f32 stage 2
    (``pallas_scan.flat_topk_fused``, ``:577-700``, without ``db_seg_lo``).

    Error budget (``pallas_scan.py:608-614``): an f32 database's "split3"
    stage 1 carries ~1e-5 relative score noise against the k+8 segment
    margin, and stage 2 is exact f32; ``precision="highest"`` is the
    provably exact (and slower) configuration.

    - 'euclidean': the kernel's ``sq - 2 ip`` surrogate;
    - 'inner_product': zero norms degrade the surrogate to ``-2 ip``;
    - 'cosine': stage 1 scans the ROW-NORMALISED matrix with a normalised
      query (surrogate ``-2 cos``, monotone in angular distance); stage 2
      computes the exact angular distance from the raw rows.

    :param db: (N, d) database, f32 or bf16, N % 128 == 0.
    :param db_sq: (N,) f32 squared row norms.
    :param valid: (N,) bool liveness mask.
    :param q: (B, d) f32 queries.
    :param db_mirror: (N, d) matrix stage 1 scans in place of ``db``: the
        row-normalised mirror for cosine (built once per call from
        ``db_norm`` when None). Ignored by the other metrics, which scan
        ``db`` itself: no transposed copy is needed.
    :param db_norm: (N,) f32 row norms; required for cosine.
    :param precision: stage 1's dot mode over an f32 database
        (:func:`segment_minima`); a bf16 database ignores it.
    :return: (dists (B, k) f32 ascending, rows (B, k) int64); entries past
        the live rows are +inf / -1.
    """
    if metric not in FUSED_METRICS:
        raise ValueError(f"flat_topk_fused serves {FUSED_METRICS}, "
                         f"not {metric!r}")
    n = db.shape[0]
    q = q.float()
    q_stage1 = q
    stage1_db = db
    if metric != "euclidean":
        db_sq = torch.zeros_like(db_sq)
    if metric == "cosine":
        if db_norm is None:
            raise ValueError("cosine needs db_norm")
        q_norm = torch.sqrt((q * q).sum(-1))
        q_stage1 = q / torch.where(q_norm == 0, 1.0, q_norm)[:, None]
        stage1_db = db_mirror if db_mirror is not None \
            else normalized_rows(db, db_norm)
    penalty = torch.where(valid, 0.0, math.inf).to(torch.float32)
    with trace_span("fused_scan.stage1"):
        minima = segment_minima(stage1_db, db_sq, penalty, q_stage1,
                                precision)
        sid = select_segments(minima, segments_kept(k, n))
    with trace_span("fused_scan.stage2"):
        return rerank_segments(db, valid, q, sid, k=k, metric=metric,
                               db_norm=db_norm)


def tiled_layout(codes: torch.Tensor, tile_n: int = TILE_N) -> torch.Tensor:
    """The single-copy tiled-transposed layout: (N, d) rows ->
    (N / tile_n, d, tile_n), row r at ``[r // tile_n, :, r % tile_n]`` (the
    JAX package's ``codes.reshape(N // tile_n, tile_n, d).transpose(0, 2,
    1)``), as a new contiguous tensor.

    :raises ValueError: N is not a multiple of ``tile_n``, or ``tile_n``
        not of 128.
    """
    n, d = codes.shape
    if tile_n % SEG or n % tile_n:
        raise ValueError(f"tiled_layout: N={n} and tile_n={tile_n} must be "
                         f"multiples of tile_n and {SEG}")
    return codes.reshape(n // tile_n, tile_n, d).transpose(1, 2).contiguous()


def blocked_layout(codes: torch.Tensor) -> torch.Tensor:
    """The segment-blocked layout: (N, d) -> (N / 128, d, 128), the tiled
    layout with ``tile_n = 128``."""
    return tiled_layout(codes, SEG)


def check_tiled(db3, db_sq, penalty, q, name: str) -> None:
    """The shapes, dtypes and device that the tiled layout's stage-1
    functions take; ``name`` heads the error."""
    if db3.dim() != 3 or q.dim() != 2 or q.shape[1] != db3.shape[1]:
        raise ValueError(f"{name}: db3 {tuple(db3.shape)} and q "
                         f"{tuple(q.shape)} must be (n_tiles, d, tile_n) "
                         "and (B, d)")
    n_tiles, _, tile_n = db3.shape
    if tile_n % SEG:
        raise ValueError(f"{name}: tile_n={tile_n} is not a multiple of "
                         f"{SEG}")
    n = n_tiles * tile_n
    if db_sq.numel() != n or penalty.numel() != n:
        raise ValueError(f"{name}: db_sq and penalty must hold N={n} "
                         "values")
    if db3.dtype not in _TILED_SUFFIX:
        raise TypeError(f"{name}: db3 dtype {db3.dtype} is not float32, "
                        "bfloat16 or int8")
    if (db_sq.dtype, penalty.dtype) != (torch.float32,) * 2:
        raise TypeError(f"{name}: db_sq and penalty must be float32")
    _check_query(q, db3.dtype, name)
    devices = {t.device for t in (db3, db_sq, penalty, q)}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices "
                         f"{sorted(map(str, devices))}")
    if db3.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {db3.device}")


def step_shape(n_tiles: int, tile_n: int) -> Tuple[int, int, int]:
    """``segment_minima_tiled2``'s step-major shape
    (``pallas_scan.py:827-833``): ``t_step`` halves from ``TILES_PER_STEP``
    until it divides ``n_tiles``; ``G = t_step * tile_n / 128`` segments a
    step; the groups of ``m2`` are ``bw = 128`` segments wide if 128
    divides G, else 16.

    :return: (n_steps, G, bw).
    :raises ValueError: ``bw`` does not divide G.
    """
    t_step = TILES_PER_STEP
    while n_tiles % t_step:
        t_step //= 2
    g = t_step * tile_n // SEG
    bw = 128 if g % 128 == 0 else 16
    if g % bw:
        raise ValueError(f"segment_minima_tiled2: G={g} segments a step is "
                         f"not a multiple of {bw}")
    return n_tiles // t_step, g, bw


def segment_minima_tiled(db3: torch.Tensor, db_sq: torch.Tensor,
                         penalty: torch.Tensor,
                         q: torch.Tensor) -> torch.Tensor:
    """
    K2: :func:`segment_minima` over the tiled layout.

    :param db3: (n_tiles, d, tile_n) f32, bf16 or int8 (SQ8 codes), tile_n
        % 128 == 0; row r is ``db3[r // tile_n, :, r % tile_n]``.
    :param db_sq: (N,) f32 squared norms in row order (``s2`` for codes).
    :param penalty: (N,) f32, 0 for live rows and +inf for dead ones.
    :param q: (B, d) f32 queries or the SQ8 fold (rounded to bf16 for a
        bf16 or int8 database), or int8 over int8 codes (the int8 x int8
        form).
    :return: (B, N // 128) f32 segment minima, in row order.
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built
        or launched. There is no fallback to the plain version.
    """
    check_tiled(db3, db_sq, penalty, q, "segment_minima_tiled")
    if db3.device.type == "cpu":
        return segment_minima_tiled_reference(db3, db_sq, penalty, q)
    n_tiles, _, tile_n = db3.shape
    nseg = n_tiles * tile_n // SEG
    out, _, form = tiled_cuda(db3, db_sq, penalty, q, nseg, 1)
    LAUNCHES["segment_minima_tiled", form] += 1
    return out[0]


def segment_minima_tiled_reference(db3: torch.Tensor, db_sq: torch.Tensor,
                                   penalty: torch.Tensor,
                                   q: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`segment_minima_tiled`: chunks of
    tiles turned back into rows and scored by
    :func:`segment_minima_reference`, so no chunk holds more than
    ``REFERENCE_BYTES`` of scores."""
    check_tiled(db3, db_sq, penalty, q, "segment_minima_tiled")
    n_tiles, d, tile_n = db3.shape
    b = q.shape[0]
    db_sq, penalty = db_sq.reshape(-1), penalty.reshape(-1)
    out = torch.empty((b, n_tiles * tile_n // SEG), dtype=torch.float32,
                      device=db3.device)
    step = max(1, REFERENCE_BYTES // (4 * max(b, 1) * tile_n))
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        lo, hi = t0 * tile_n, t1 * tile_n
        rows = db3[t0:t1].transpose(1, 2).reshape(-1, d)
        # The tiled f32 kernels add in FFMA: "highest".
        out[:, lo // SEG:hi // SEG] = segment_minima_reference(
            rows, db_sq[lo:hi], penalty[lo:hi], q, "highest")
    return out


def segment_minima_blocked(db_blk: torch.Tensor, db_sq: torch.Tensor,
                           penalty: torch.Tensor,
                           q: torch.Tensor) -> torch.Tensor:
    """
    K4: :func:`segment_minima` over the blocked layout
    (``pallas_scan.segment_minima_blocked``).

    :param db_blk: (N / 128, d, 128) f32, bf16 or int8.
    :param db_sq: (N / 128, 128) f32 squared norms (the same blocking).
    :param penalty: (N / 128, 128) f32, 0 live / +inf dead.
    :param q: (B, d) f32, or int8 over int8 codes.
    :return: (B, N // 128) f32 segment minima.
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built
        or launched. There is no fallback to the plain version.
    """
    _check_blocked(db_blk, db_sq, penalty)
    check_tiled(db_blk, db_sq, penalty, q, "segment_minima_blocked")
    if db_blk.device.type == "cpu":
        return segment_minima_blocked_reference(db_blk, db_sq, penalty, q)
    out, _, form = tiled_cuda(db_blk, db_sq, penalty, q, db_blk.shape[0], 1)
    LAUNCHES["segment_minima_blocked", form] += 1
    return out[0]


def _check_blocked(db_blk, db_sq, penalty) -> None:
    nseg = db_blk.shape[0]
    if db_blk.dim() != 3 or db_blk.shape[2] != SEG \
            or db_sq.shape != (nseg, SEG) or penalty.shape != (nseg, SEG):
        raise ValueError(
            f"segment_minima_blocked: db_blk {tuple(db_blk.shape)} must be "
            f"(nseg, d, {SEG}) and db_sq, penalty (nseg, {SEG})")


def segment_minima_blocked_reference(db_blk: torch.Tensor,
                                     db_sq: torch.Tensor,
                                     penalty: torch.Tensor,
                                     q: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of :func:`segment_minima_blocked`: the
    tiled layout's plain version with ``tile_n = 128``."""
    _check_blocked(db_blk, db_sq, penalty)
    return segment_minima_tiled_reference(db_blk, db_sq, penalty, q)


def segment_minima_tiled2(db3: torch.Tensor, db_sq: torch.Tensor,
                          penalty: torch.Tensor, q: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    K5: :func:`segment_minima_tiled` step-major, with per-group minima
    (``pallas_scan.segment_minima_tiled2``).

    With (n_steps, G, bw) from :func:`step_shape`, segment ``s`` of the row
    order is ``m1[s // G, :, s % G]``, and ``m2[step, :, j]`` is the minimum
    of ``m1[step, :, j * bw:(j + 1) * bw]``.

    :param db3, db_sq, penalty, q: as :func:`segment_minima_tiled`.
    :return: (m1 (n_steps, B, G), m2 (n_steps, B, G // bw)) f32.
    :raises RuntimeError: on CUDA tensors, if the kernel cannot be built
        or launched. There is no fallback to the plain version.
    """
    check_tiled(db3, db_sq, penalty, q, "segment_minima_tiled2")
    if db3.device.type == "cpu":
        return segment_minima_tiled2_reference(db3, db_sq, penalty, q)
    n_tiles, _, tile_n = db3.shape
    _, g, bw = step_shape(n_tiles, tile_n)
    m1, m2, form = tiled_cuda(db3, db_sq, penalty, q, g, bw)
    LAUNCHES["segment_minima_tiled2", form] += 1
    return m1, m2


def segment_minima_tiled2_reference(db3: torch.Tensor, db_sq: torch.Tensor,
                                    penalty: torch.Tensor, q: torch.Tensor
                                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of :func:`segment_minima_tiled2`: K2's
    plain minima, cut into steps, and their group minima."""
    n_tiles, _, tile_n = db3.shape
    n_steps, g, bw = step_shape(n_tiles, tile_n)
    b = q.shape[0]
    minima = segment_minima_tiled_reference(db3, db_sq, penalty, q)
    m1 = minima.view(b, n_steps, g).transpose(0, 1).contiguous()
    return m1, m1.view(n_steps, b, g // bw, bw).amin(-1)


def tiled_cuda(db3, db_sq, penalty, q, g: int, bw: int, *,
               scale: float = 1.0, variant: Optional[int] = None):
    """Launch a stage-1 kernel over the tiled layout on the current
    stream: the one launcher of K2, K4, K5, K9 and K10. The caller has run
    :func:`check_tiled` and counts the launch.

    - ``variant`` None: the (B, N / 128) form when ``g`` is N / 128 and
      ``bw`` 1 (K2, K4), else the step-major pair (K5). Over int8 codes
      ``csrc/segment_minima_tiled_wgmma.cu`` on the tensor cores: with a
      float query as bf16, or with an int8 query (the int8 x int8 form,
      its products times ``scale``); over an f32 or bf16 database, FFMA
      (``csrc/segment_minima_tiled.cu``).
    - ``variant`` one of ``csrc/segment_minima_tiled_wgmma.cu``'s
      ``Variant`` values (K9): the same kernel with that epilogue, over
      int8 codes into the step-major (n_steps, B, g) layout, with a bf16
      or an int8 query; ``bw`` is 1 and the products are not scaled.

    The FFMA kernels read an f32 query (rounded to bf16 first for a bf16
    or int8 database), the ``wgmma`` ones a bf16 query, the int8 x int8
    ones an int8 query as it is.

    :return: (out (n_steps, B, g), group minima (n_steps, B, g // bw) or
        None for ``bw == 1``, the form of the entry point it launched:
        ``ffma``, ``wgmma`` or ``wgmma_s8``, from :data:`_ENTRY_FORM`).
    :raises ValueError: the kernels cannot take these tensors.
    """
    n_tiles, d, tile_n = db3.shape
    b = q.shape[0]
    nseg = n_tiles * tile_n // SEG
    depth = 32 if q.dtype == torch.int8 else 16
    if d % depth:
        raise ValueError(f"segment_minima_tiled: d={d} is not a multiple of "
                         f"{depth} (stores pad it with pad_dim)")
    if variant is not None and (db3.dtype != torch.int8 or bw != 1):
        raise ValueError("the stage-1 variants take int8 codes and bw 1")
    i8i8 = q.dtype == torch.int8
    suffix = "i8i8" if i8i8 else _TILED_SUFFIX[db3.dtype]
    name = (f"stage1_variant_{suffix}" if variant is not None
            else f"segment_minima_tiled_{suffix}" if bw == 1
            else f"segment_minima_tiled2_{suffix}")
    form = _ENTRY_FORM[name]
    qk = _query_operand(q, db3.dtype, form)
    for what, t in (("db3", db3), ("db_sq", db_sq), ("penalty", penalty)):
        if not t.is_contiguous():
            raise ValueError(f"segment_minima_tiled: {what} is not "
                             "contiguous")
    if any(t.data_ptr() % 16 for t in (db3, qk, db_sq, penalty)):
        raise ValueError("segment_minima_tiled: db3, q, db_sq and penalty "
                         "must be 16-byte aligned")
    if -(-b // 128) * (nseg // bw) >= 2 ** 31:
        raise ValueError("segment_minima_tiled: grid exceeds 2^31 blocks")
    out = torch.empty((nseg // g, b, g), dtype=torch.float32,
                      device=db3.device)
    lib = _kernels.library()
    scale_arg = (float(scale),) if i8i8 else ()
    stream = torch.cuda.current_stream(db3.device).cuda_stream
    groups = None if variant is not None or bw == 1 else torch.empty(
        (nseg // g, b, g // bw), dtype=torch.float32, device=db3.device)
    with torch.cuda.device(db3.device):          # see _kernels.library
        if variant is not None:
            err = getattr(lib, name)(
                qk.data_ptr(), db3.data_ptr(), db_sq.data_ptr(),
                penalty.data_ptr(), out.data_ptr(), b, n_tiles, d, tile_n,
                g, variant, db3.device.index, stream)
        elif bw == 1:
            err = getattr(lib, name)(
                qk.data_ptr(), db3.data_ptr(), db_sq.data_ptr(),
                penalty.data_ptr(), out.data_ptr(), b, n_tiles, d, tile_n,
                *scale_arg, db3.device.index, stream)
        else:
            err = getattr(lib, name)(
                qk.data_ptr(), db3.data_ptr(), db_sq.data_ptr(),
                penalty.data_ptr(), out.data_ptr(), groups.data_ptr(), b,
                n_tiles, d, tile_n, g, bw, *scale_arg, db3.device.index,
                stream)
    _kernels.check(err, name)
    return out, groups, form


def topk_segments_stepmajor(m1: torch.Tensor, m2: torch.Tensor, s_keep: int
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Exact top-``s_keep`` smallest segment minima from the step-major pair
    of :func:`segment_minima_tiled2` (``pallas_scan.py:873-908``): rank the
    group minima, then refine inside the winning groups. At most
    ``s_keep`` groups can hold a top-``s_keep`` minimum (each group minimum
    is itself a segment minimum), so the refinement is exact.

    :return: (values ascending, global segment ids ``step * G + g``), both
        (B, s_keep) (fewer where there are fewer segments).
    """
    s_steps, b, g = m1.shape
    gb = m2.shape[2]
    bw = g // gb
    bm = m2.transpose(0, 1).reshape(b, s_steps * gb)
    s_eff = min(s_keep, s_steps * gb)
    _, bidx = topk_smallest(bm, s_eff)                       # (B, s_eff)
    step = bidx // gb
    grp = bidx % gb
    # Each winning group is one contiguous bw-wide row of m1.
    rowid = (step * b + torch.arange(b, device=m1.device)[:, None]) * gb \
        + grp
    cand = m1.reshape(s_steps * b * gb, bw)[rowid].reshape(b, s_eff * bw)
    seg = ((step * g + grp * bw)[..., None]
           + torch.arange(bw, device=m1.device)).reshape(b, s_eff * bw)
    vals, sel = topk_smallest(cand, min(s_keep, s_eff * bw))
    return vals, torch.gather(seg, 1, sel)
