#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``smqtk_indexing_tpu_torch``) on one CUDA
card.

    python3 chip_smoke.py                  # from the repository root

Phases, each printing JSON lines; any failure raises, so the exit code is
not 0:

0. card: the card's name and power limit from ``nvidia-smi``;
1. build: the hand-written kernels compiled with ``nvcc`` for sm_90a, one
   ``nvcc`` a source, all at once, then linked into one library; the
   count of tensor-core instructions in each instantiation of the two
   wgmma kernels (K1's bf16, int8-code, int8 x int8, f32 split3 and f32
   native forms; K2 / K4 / K5 over int8 codes with a bf16 and with an
   int8 query, and K9's variants of that kernel), read with ``cuobjdump
   -sass`` (HGMMA for the bf16 products, IGMMA for the int8 ones), must
   not be 0 (and must be 0 in K9's ``nodot``, which takes no product),
   and ptxas must report no spill in any of them nor in the IVF list
   scans (K8, K7 and K6's f32, bf16 and int8 forms; their registers are
   printed, and go on the IVF kernels' rows of the ``kernels`` line);
2. flat kernels: K1 (``segment_minima``) against its plain PyTorch version
   at the flat path's shapes (B=2048 queries, N=1,048,576 rows, d=128; f32
   with dead rows in its three precisions: the exact FFMA form
   ``highest``, and ``split3`` and ``native`` on the tensor cores, held
   against float64 over the f32 rows and over the bf16-rounded operands;
   split3 also over rows scaled by 2^-126, whose lo parts are bf16
   subnormals; and the bf16 form on the tensor cores, also against
   float64), timed with CUDA events as plain, kernel, kernel, plain; the
   bf16 and int8-code forms at d=1024 the same way; plus the selection,
   stage-2 and whole ``flat_topk_fused`` times at the f32 shapes (split3,
   beside the ``highest`` stage 1);
3. flat path: ``FlatNearestNeighborsIndex(device="cuda")`` over 1,000,000
   x 128 SIFT1M-shaped vectors (uniform * 218, seed 0, as ``bench.py``
   makes them), through ``build_index`` / ``nn_many`` with 2048 held-out
   queries at k=10, with the per-batch host-clock split of ``nn_many``
   into ``store.knn`` and result assembly (from the tracing spans); every
   K1 launch must take split3 (``SMQTK_TPU_STAGE1`` unset), self-queries
   must return themselves at 0.0, the reported distances must be the
   float64 ones of the rows found, and recall@10 against a float64
   oracle must be 1.0. Then three batches with
   ``SMQTK_TPU_STAGE1=highest`` (every launch FFMA, the same checks) and
   three with ``native`` (the same checks but recall, which is read).
   Then smaller builds for inner_product and cosine (split3),
   and ``dtype="bfloat16"`` at the full size (K1's bf16 form;
   recall@10 against float64 over the bf16 rows must be 1.0);
4. IVF serving line: ``IvfNearestNeighborsIndex(n_lists=4096, nprobe=4,
   dtype="sq8", storage="code", rerank="score", device="cuda")`` over
   1,000,000 x 96 clustered Deep1M-shaped vectors (``bench.py``'s recipe,
   seed 2, 1,024 held-out queries). K7 (``ivf_list_scores_tiled``) and
   K3 (``seg_gather_tiled``) against their plain versions and float64 at
   the built index's operands (B=1024); then 5 timed ``nn_many(1024,
   k=10)`` batches with the ``ivf.query`` / ``ivf.assemble`` split, peak
   device bytes and recall@10 against float64 (128 queries), which must
   be >= 0.95; the index built a second time from the same seed, with no
   determinism switch, whose centroids, codec, tiles of codes and row
   stats, slot table and answers must equal the first build's bit for
   bit; then ``rerank="exact"`` on the same index (K3), whose recall
   must be no worse than score mode's less 0.01;
5. IVF rows tier: ``storage="rows"`` with float32 and sq8 over the same
   vectors at nprobe=4 (K6, ``ivf_list_scores``: its f32 and int8 forms
   held against their plain versions and float64 at each index's
   operands, and its bf16 form on the f32 index's rows cast to bf16),
   then nprobe = n_lists on 128 queries, which must give recall@10 = 1.0
   for float32, then two batches of the float32 index with its rows cast
   to bf16 (K6's bf16 form), whose recall@10 must be within 0.02 of
   float32's;
6. IVF-PQ code tier: ``IvfNearestNeighborsIndex(n_lists=4096,
   nprobe=16, dtype="opq16", storage="code", pq_residual=True,
   rerank="exact", device="cuda")`` (the 'OPQ16,IVF4096,PQ16' by_residual
   configuration) over 1,000,000 x 96 vectors of ``bench_all.py``'s rank-8
   correlated recipe (seed 2, 1,024 held-out queries). K8
   (``ivf_list_scores_tiled_pq``) against its plain version and float64
   at the built index's operands (B=1024); 5 timed batches, recall@10
   against float64 over the raw vectors (>= 0.85); ``rerank="score"``
   (within 0.01 of exact mode); the index built a second time from the
   same seed and held to the first bit for bit (centroids, codebooks,
   rotation, codes, answers), as phase 4's; nprobe = n_lists on 128
   queries, whose top-10 must be the float64 top-10 over the index's
   reconstructions;
7. IVF-PQ rows tier: ``dtype="pq16", storage="rows", pq_residual=True``
   at nprobe=4 on the same vectors, routed to K8 (recall@10 >= 0.75);
8. flat codecs: ``FlatNearestNeighborsIndex(dtype="sq8")`` over the flat
   phase's vectors, whose stage 1 is K1's int8 form (held against its
   plain version and float64 at the store's operands; timed batches with
   their span split) and, under
   ``SMQTK_TPU_SQ8_I8DOT=1``, K1's int8 x int8 form on ``wgmma`` s8 (held
   bit for bit against its plain version at B=2048, N=2^20; every K1
   launch of the flag's batches must take it), then ``dtype="pq16"``; each
   top-10 of 128 queries must be the float64 top-10 over the store's
   quantized rows;
9. the K10 probe (``smqtk_indexing_tpu_torch.tools.probe_int8_mxu``) over
   16,777,216 x 128 codes made on the card: both arms held against their
   plain versions (the int8 arm bit for bit), then the probe itself (rank
   agreement and the pipelined A/B), its 2.1 GB freed after;
10. capacity scan (``smqtk_indexing_tpu_torch.examples.capacity_100m``):
   100,663,296 x 128 SQ8 codes built on the card in the tiled layout with
   planted truth; K2, K4 and K5 held against their plain versions and
   float64 at B=128 on a 4,194,304-row prefix with dead rows (their int8
   -code, float-query form on the tensor cores; K5's m2 must be the group
   minimum of its m1, bit for bit); then
   ``sq8_topk_blocked`` at full scale, B=128 and B=256, k=16: recall@10
   on the planted rows 1.0, margin > 1.0, the first 16 queries' top-16
   equal to the plain pipeline's (B=128), three timed batches (whose K5
   launches must all take the tensor-core form), the stage split and the
   peak device bytes; last the blocked layout end to end at
   the prefix (K4), equal to the tiled layout's results. The same with
   ``i8dot=True``: K2, K4 and K5's int8 x int8 forms held bit for bit on
   the prefix, the scan at B=128 and 256 (recall@10 1.0, margin, equal to
   the plain pipeline; every K5 launch ``wgmma_s8``) beside the flag-off
   numbers, its stage split and the blocked layout at the prefix. Then
   each K9 variant
   (``smqtk_indexing_tpu_torch.tools.stage1_analysis``; instantiations
   of the tiled tensor-core kernel) held against its plain version on the
   prefix with both query forms, beside production's K2 and K5 times of
   the same form (``full`` must give K2's output bit for bit), and the K9
   sweep (every variant x t_step in {2, 4, 8}) on the resident index.
11. hashing and LSH, at ``bench_all.py``'s LSH record's size
   (``bench_all.py:122-175``, ``:355-420``): 1,000,000 x 128 rows of its
   rank-None SIFT-shaped mixture (``lsh_data``, seed 0) and 1,024 held-out
   queries; ``ItqFunctor(bit_length=128, random_seed=0)`` fitted on a
   100,000-row sample in 50 iterations (fit seconds, cold and warm);
   whether the native host library built; a ``LinearHashIndex`` over the
   1M codes (~970K unique, capacity 2^20: the ±1 route) queried at
   B=1024, top-16 (queries/s, median of 5; every launch K1's bf16 form);
   on 128 queries its distances must equal the XOR route's on the same
   card and a numpy byte-table popcount's, its codes below the 16th
   distance theirs; K1 alone at (1024, 2^20, 128) held bit for bit
   against its plain version (±1 products and their f32 sums are exact)
   beside ``torch.mm`` bf16; then ``LSHNearestNeighborIndex(
   distance_method="euclidean")`` over the 1M rows (build and fused-state
   seconds, unique codes, l_max, engine), ``nn_many(., 10)`` at B=128 and
   1,024, fused and under ``SMQTK_TPU_NO_LSH_FUSED=1`` (queries/s, K1
   launches, span split, ``count()`` ms); on 128 queries every answer must
   be valid against float64 for its choice among codes tied at the 10th
   Hamming distance, and both paths equal where no code ties there;
   recall@10 against float64 is printed, with no bar.
12. MRPT at the GIST1M shape (``BASELINE.md``'s config 4): 1,000,000 x 960
   rows of ``bench_all.py``'s rank-None mixture (``mrpt_data``, seed 4)
   and 64 held-out queries, k=10, with a float64 top-10 on the card.
   ``MRPTNearestNeighborsIndex(num_trees=8, depth=9)`` builds its
   leaf-ordered SQ8 mirror (8 GiB, exactly ``MIRROR_BUDGET``) and serves
   through K6's int8 form, held against its plain version and float64 at
   the mirror's windows (all 64 queries, d=1,024); ``(16, 7)`` is over
   the budget and takes the gather route; the (8, 9) payload reloaded
   under ``SMQTK_TPU_NO_MRPT_MIRROR=1`` takes the gather route on the
   same trees. Each: build seconds, 5 timed batches (queries/s, the
   ``mrpt.query`` / ``mrpt.assemble`` split), K6 launches (none on the
   gather route), recall@10 (read, no bar), every distance the float64
   one of its row and no row twice; the two routes' recall@10 on the same
   trees within 0.02;
13. the front ends on phase 4's vectors: ``FaissNearestNeighborsIndex``
   from a config written for the reference's FAISS wrapper
   (``"IVF4096,SQ8"``, ``"l2"``, ``ivf_nprobe`` 4, seed 0), whose answers
   must equal those of ``IvfNearestNeighborsIndex`` built directly with
   the same parameters (one seed trains one set of centroids: the
   k-means sums are exact, ``ops/kmeans.cell_sums``), then
   ``AutotunedNearestNeighborsIndex(autotune=True,
   target_precision=0.95)``: the nprobe it chose and its recall@10;
14. ``sharded-deep10m-shape`` (``BASELINE.md:51``'s config 5): bench.py's
   clustered recipe at 10,000,000 x 96 (drawn on the card, seed 2) with
   1,024 held-out queries, n_devices=4 on four cards where four are
   visible, else on ``["cuda:0"] * 4`` (printed). Each index beside the
   same index on one device, the sharded one loading the single one's
   payload: ``FlatNearestNeighborsIndex`` (the same rows but near ties at
   the k-th place, float64 distances over the rows found, recall@10 = 1.0
   against float64 on 128 queries), then ``IvfNearestNeighborsIndex(
   n_lists=4096, nprobe=4, dtype="sq8", storage="code", rerank="score")``
   (K7 a shard), its ``rerank="exact"`` (K3) and ``dtype="pq16"`` (K8),
   each with the same rows and bit-equal distances; queries/s at B=1024,
   the span split, each shard's device bytes and each card's peak, and
   each shard's launches of K7, K3 and K8 (read around each shard's
   search); K7, K3 and K8 held against their plain versions (and float64)
   on shard 0's operands, and timed on every shard's own operands. Then
   ``host-stream-deep10m-shape``: ``FlatNearestNeighborsIndex(storage=
   "host_stream")`` loaded from the single-device flat index's payload
   (the same 10M rows, streamed from host memory in blocks of 2^20 rows,
   each scanned by ``scan.flat_topk``; no kernel may launch), three
   B=1,024 batches whose every id and distance must equal the
   single-device index's bit for bit; queries/s, the copy's GB/s (the
   staging path alone, and the pinned copy alone), the per-block scans'
   share of a batch and the peak device bytes;
15. every other sharded route once, each against its single-device
   counterpart: the IVF rows tier (float32, sq8; the list gathers a shard
   against K6) and MRPT t8/d9 (the gather route on both) on phase 4's
   vectors, one ``sharded_kmeans_step`` (bit-equal to the same
   fixed-point step on one device, within 1e-6 of float64 per-cell
   means), LSH (SimpleRP-10, two calls), the flat store's sq8 and
   pq16 on phase 3's vectors (each trains one codec from one seed), the
   flat store on a 2-D (dcn=2) mesh (equal to the 1-D mesh) and
   ``LinearHashIndex`` over 64-bit codes (the XOR route a shard against
   K1's ±1 route: equal distances);
16. ``ivf16384-100m`` at reduced depth: the ported
   ``examples/ivf_100m.py`` at ``SMQTK_IVF100M_CHUNKS=2`` (12,582,912 x
   128 rows at full width, 16,384 lists), SQ8 then residual PQ16, its
   recall checks raising (>= 0.99 against the exhaustive SQ8 oracle and
   against the ADC oracle at nprobe 2 to 16); K5 and K3 (the oracle), K7
   and K8 (nprobe 16, B=128) held against their plain versions (and
   float64) on the example's operands, their launches in the run read
   apart from the holds'.

Each path sets the kernels' launch counts to 0 just before it runs and
reads them just after. Then a ``{"kernels": [...]}`` line with each
kernel's launches in its path, its error against its plain version, its
time and the plain version's, its bound (the larger of its bytes over the
memory rate and its operations over the peak rate of their type, from
this run's inputs) and the time of one PyTorch call of the same function
where there is one (``torch.mm``, or ``torch._int_mm`` for the int8 x int8
forms: K1, K2, K4, K5, K9, K10; K3's gather as one advanced indexing of
the tiled codes; the port never calls any of them); K5's rows also carry
its capacity ms at B=128 and 256, K9's rows production K2's ms of each
query form; and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import time

import numpy as np

N_MAIN = 1_000_000
DIM = 128
BATCH = 2048
K = 10
N_SMALL = 200_000
B_SMALL = 256
N_ORACLE = 128
#: Kernel vs plain version, and vs float64: both sum exact f32 (or bf16 x
#: bf16, int8 x f32) products in f32 in different orders, so they differ
#: by rounding only: at most 1e-5 of the largest sum of absolute terms.
REL_TOL = 1e-5
IVF_N = 1_000_000
IVF_DIM = 96
IVF_BATCH = 1024
IVF_LISTS = 4096
IVF_NPROBE = 4
#: The recall the serving line must reach (bench.py's line read 0.9672).
IVF_RECALL_FLOOR = 0.95
#: IVF-PQ: 'OPQ16,IVF4096,PQ16' by_residual on the code tier at nprobe=16,
#: and residual PQ16 on the rows tier at nprobe=4. The floors sit under
#: the JAX package's record on the same data (docs/benchmarks.md:214:
#: 0.892 and 0.787), with a margin for training on another backend.
PQ_NPROBE = 16
PQ_RECALL_FLOOR = 0.85
PQ_ROWS_NPROBE = 4
PQ_ROWS_RECALL_FLOOR = 0.75
#: Distances reported by an exact re-rank (f32, codec space) against
#: float64 over the same reconstructions.
RECON_TOL = 1e-4
#: The capacity phase holds K2, K4 and K5 on this many tiles of its layout
#: (4,194,304 rows), where the plain versions and float64 stay affordable,
#: and compares the full-scale scan with the plain pipeline on this many
#: queries.
CAP_PREFIX_TILES = 1024
CAP_PLAIN_QUERIES = 16
#: Peaks of one H100 SXM (NVIDIA's data sheet): device memory bytes/s,
#: FP32 outside the tensor cores, dense bf16 on the tensor cores (FLOP/s),
#: dense int8 on the tensor cores (operations/s).
HBM_BYTES_S = 3.35e12
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn`` over ``reps`` back-to-back calls,
    between two CUDA events."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def oracle_topk(x: np.ndarray, q: np.ndarray, k: int, metric: str):
    """Float64 top-k row ids (sets) for the matmul metrics."""
    x64 = x.astype(np.float64)
    q64 = q.astype(np.float64)
    ip = q64 @ x64.T
    if metric == "euclidean":
        score = (x64 * x64).sum(1)[None, :] - 2.0 * ip
    elif metric == "inner_product":
        score = -ip
    else:
        score = -ip / np.linalg.norm(x64, axis=1)[None, :]
    return np.argpartition(score, k, axis=1)[:, :k]


def recall(found, truth) -> float:
    hits = sum(len(set(f) & set(t.tolist())) for f, t in zip(found, truth))
    return hits / truth.size


def _count_dicts():
    """The launch-count dicts of the kernels other than ``fused_scan``'s,
    with the prefix of their names in :func:`read_counts`."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    from smqtk_indexing_tpu_torch.tools import probe_int8_mxu, stage1_analysis
    return (("", ivf_scan.LAUNCHES),
            ("scan_minima:", probe_int8_mxu.LAUNCHES),
            ("stage1_variant:", stage1_analysis.LAUNCHES))


def reset_counts() -> None:
    """Set every kernel's launch count to 0."""
    from smqtk_indexing_tpu_torch.ops import fused_scan
    for counts in (fused_scan.LAUNCHES,) + tuple(
            c for _, c in _count_dicts()):
        for name in counts:
            counts[name] = 0


def read_counts() -> dict:
    """Every kernel's launch count: ``fused_scan``'s as ``<wrapper>:<form>``
    (form ``ffma``, ``wgmma``, ``wgmma_s8`` or ``copy``), K10's arms as
    ``scan_minima:<arm>``, K9's variants as ``stage1_variant:<variant>``."""
    from smqtk_indexing_tpu_torch.ops import fused_scan
    out = {f"{w}:{f}": n for (w, f), n in fused_scan.LAUNCHES.items()}
    for prefix, counts in _count_dicts():
        out.update({prefix + name: n for name, n in counts.items()})
    return out


def bound(nbytes: float, flops: float, peak: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over the
    memory rate and its operations over ``peak``, the rate of their type."""
    by_bytes = nbytes / HBM_BYTES_S * 1e3
    by_ops = flops / peak * 1e3
    return {"bound_ms": max(by_bytes, by_ops),
            "bound_by": "bytes" if by_bytes >= by_ops else "operations"}


def stage1_bound(b: int, n: int, d: int, esize: int, out_elems: int,
                 exact_f32: bool = False, int8_query: bool = False,
                 passes: int = 1) -> dict:
    """K1, K2, K4, K5, K10: the database, its row stats and penalty, the
    queries and the f32 outputs once; 2 B N d operations a pass, at the
    FP32 rate for an f32 database under "highest" (only FFMA keeps those
    products exact), at the int8 tensor-core rate for an int8 query over
    int8 codes, and at the bf16 tensor-core rate otherwise (a bf16 or int8
    database's products with the bf16-rounded query are exact there; an
    f32 database's split3 takes three passes over its bf16 parts, native
    one)."""
    peak = FP32_FLOPS if exact_f32 else INT8_OPS if int8_query \
        else BF16_FLOPS
    return bound(n * d * esize + 8 * n + (1 if int8_query else 4) * b * d
                 + 4 * out_elems, passes * 2.0 * b * n * d, peak)


def distinct_positions(base, lo, hi, width: int, size: int):
    """(distinct positions, live (slot, lane) pairs) of the windows
    ``base + [lo, hi)`` over an axis of ``size`` positions: what a windowed
    kernel must read, each position once, and the pairs it scores."""
    import torch
    lane = torch.arange(width, device=base.device)
    live = (lane >= lo[..., None]) & (lane < hi[..., None])
    pos = (base.long()[..., None] + lane)[live]
    mark = torch.zeros(size, dtype=torch.bool, device=base.device)
    mark[pos] = True
    return int(mark.sum()), int(live.sum())


def library_mm(a, b_t, reps: int = 3) -> float:
    """Mean ms of one ``torch.mm`` of the same product as a stage-1 kernel,
    or of one ``torch._int_mm`` (int32 out) for int8 operands (the
    yardstick ``library_ms``; the port never calls either)."""
    import torch

    def fn():
        if a.dtype == torch.int8:
            return torch._int_mm(a, b_t)
        return torch.mm(a, b_t)
    fn()                                                   # warm-up
    ms = cuda_ms(fn, reps)
    torch.cuda.empty_cache()
    return ms


def library_gather(db3, sid, reps: int = 10) -> float:
    """Mean ms of K3's gather as one PyTorch call: the tiled codes viewed
    as (n_tiles, d, tile_n / 128, 128), indexed by each segment's (tile,
    column block), which gives (B, s_keep, d, 128) (the yardstick
    ``library_ms``; the port never calls it). Raises unless it equals
    the kernel's output."""
    import torch
    from smqtk_indexing_tpu_torch.ops import fused_scan
    n_tiles, d, tile_n = db3.shape
    nseg_t = tile_n // fused_scan.SEG
    view = db3.view(n_tiles, d, nseg_t, fused_scan.SEG)
    sid = sid.long()

    def fn():
        return view[sid // nseg_t, :, sid % nseg_t]
    if not torch.equal(fn(), fused_scan.seg_gather_tiled(db3, sid)):
        raise RuntimeError("K3's library gather disagrees with the kernel")
    ms = cuda_ms(fn, reps)
    torch.cuda.empty_cache()
    return ms


@contextlib.contextmanager
def plain_kernels():
    """``sq8_topk_blocked`` with its kernels swapped for their plain
    versions: the plain pipeline."""
    from smqtk_indexing_tpu_torch.ops import fused_scan, sq8
    swap = {"segment_minima_tiled2": fused_scan.segment_minima_tiled2_reference,
            "segment_minima_blocked":
                fused_scan.segment_minima_blocked_reference,
            "seg_gather_tiled": fused_scan.seg_gather_tiled_reference}
    saved = {name: getattr(sq8, name) for name in swap}
    for name, fn in swap.items():
        setattr(sq8, name, fn)
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(sq8, name, fn)


def hold(name: str, kernel, plain, smi: str, *, compare: str, f64=None,
         reps=(10, 3), q_axis: int = 0, n_f64: int = N_ORACLE, **info):
    """
    Hold a kernel against its plain version (all queries) and time both
    with CUDA events as plain, kernel, kernel, plain. ``compare`` is the
    test, which raises on disagreement:

    - ``"equal"``: bit for bit (a copy, or exact integer products);
    - ``"f64"``: within REL_TOL of the largest sum of absolute terms, of
      the plain version and of float64 on the first ``n_f64`` queries along
      ``q_axis`` of the output; ``f64()`` returns (exact scores, the sum of
      the absolute terms of each score);
    - ``"plain"``: within REL_TOL of the plain version's largest magnitude
      (a probe's variant with no float64 form);
    - ``"plain_bf16"``: as ``"plain"``, plus one bf16 unit in the last
      place of each value (``stage1_analysis.bf16_ulp``: scores rounded
      to bf16 after f32 sums in another order may take the neighbouring
      bf16).

    :return: (max |kernel - plain|, mean kernel ms, mean plain ms).
    """
    import torch
    if compare not in ("equal", "f64", "plain", "plain_bf16") \
            or (compare == "f64") != (f64 is not None):
        raise ValueError(f"hold {name}: compare={compare!r} with f64={f64}")
    ref = plain()
    out = kernel()
    torch.cuda.synchronize()
    inf_match = bool(torch.equal(torch.isinf(ref), torch.isinf(out)))
    fin = torch.isfinite(ref)
    diff = (out - ref)[fin].abs()
    err = diff.max().item() if diff.numel() else 0.0
    f64_err = None
    if compare == "equal":
        ok = bool(torch.equal(out, ref))
        tol = 0.0
    elif compare != "f64":
        tol = REL_TOL * ref[fin].abs().max().item()
        allowed = tol
        if compare == "plain_bf16":
            from smqtk_indexing_tpu_torch.tools.stage1_analysis import (
                bf16_ulp,
            )
            allowed = allowed + bf16_ulp(ref[fin])
        ok = inf_match and bool((diff <= allowed).all())
    else:
        exact, mag = f64()
        fin64 = torch.isfinite(exact)
        f64_err = (out.narrow(q_axis, 0, n_f64).double()
                   - exact)[fin64].abs().max().item()
        tol = REL_TOL * mag[fin64].max().item()
        ok = inf_match and err <= tol and f64_err <= tol
        del exact, mag
    del diff, fin
    plain(), kernel()                                      # warm-up
    t_plain = [cuda_ms(plain, reps[1])]
    t_kernel = [cuda_ms(kernel, reps[0]), cuda_ms(kernel, reps[0])]
    t_plain.append(cuda_ms(plain, reps[1]))
    emit("kernel", kernel=name, compare=compare, max_abs_err=err,
         f64_max_abs_err=f64_err, tol=tol, inf_match=inf_match,
         ms=t_kernel, plain_ms=t_plain, card=smi, ok=ok, **info)
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version")
    del ref, out
    torch.cuda.empty_cache()
    return err, statistics.mean(t_kernel), statistics.mean(t_plain)


def flat_data():
    """bench.py's SIFT1M-shaped flat data: uniform * 218, seed 0."""
    rng = np.random.default_rng(0)
    data = rng.random((N_MAIN, DIM), dtype=np.float32) * 218.0
    queries = rng.random((BATCH, DIM), dtype=np.float32) * 218.0
    return data, queries


def split_of_spans(names) -> dict:
    """Mean host-clock ms a call of each tracing span since the last
    ``COUNTERS.reset()``."""
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS
    spans = COUNTERS.snapshot()
    return {name: 1e3 * spans[f"span.{name}.seconds"]
            / spans[f"span.{name}.calls"]
            for name in names if spans.get(f"span.{name}.calls")}


def flat_batches(index, q_elems, n_batches: int):
    """A warm-up and ``n_batches`` timed ``nn_many(q_elems, K)`` batches:
    (results of the last, seconds of each, their host-clock split by the
    tracing spans, the kernels' launch counts in them). ``store.knn``
    copies its results back, so its span holds the device work; the
    assembly is host work only."""
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS
    index.nn_many(q_elems, K)                              # warm-up
    reset_counts()
    COUNTERS.reset()
    batch_s = []
    for _ in range(n_batches):
        t0 = time.perf_counter()
        res = index.nn_many(q_elems, K)
        batch_s.append(time.perf_counter() - t0)
    return res, batch_s, split_of_spans(
        ("flat.query", "store.knn", "flat.assemble")), read_counts()


def k1_f64(db_sq, penalty, q, x, q_bf16: bool = True):
    """``hold``'s float64 check of K1 on the first N_ORACLE queries:
    (exact minima, largest sum of absolute terms |db_sq| + 2 |q| . |x| of
    each segment), with the query rounded to bf16 as the bf16, int8-code
    and f32 native forms take it (``x`` rounded too for native), or as it
    is (``q_bf16=False``: the f32 split3 form against the f32 rows)."""
    import torch

    def f64():
        q64 = q[:N_ORACLE]
        q64 = (q64.to(torch.bfloat16) if q_bf16 else q64).double()
        x64 = x.double()
        exact = ((db_sq.double() - 2.0 * (q64 @ x64.T))
                 + penalty.double()).view(N_ORACLE, -1, 128).amin(-1)
        mag = (db_sq.double().abs() + 2.0 * (q64.abs() @ x64.abs().T)) \
            .view(N_ORACLE, -1, 128).amax(-1)
        return exact, mag
    return f64


def k1_wide(smi: str, dev, dim: int = 1024) -> None:
    """K1's bf16 and int8-code forms at B=2048, N=2^20 and a large d (the
    query streams through the kernel's ring), held against their plain
    versions and float64; "kernel" lines only."""
    import torch
    from smqtk_indexing_tpu_torch.ops import fused_scan
    n = 1 << 20
    g = torch.Generator(device=dev).manual_seed(1)
    penalty = torch.where(torch.rand(n, generator=g, device=dev) < 0.01,
                          float("inf"), 0.0)
    for name in ("segment_minima_bf16", "segment_minima_i8"):
        if name == "segment_minima_bf16":
            x = (torch.rand((n, dim), generator=g, device=dev) * 218.0) \
                .to(torch.bfloat16)
            q = torch.rand((BATCH, dim), generator=g, device=dev) * 218.0
            db_sq = x.float().pow(2).sum(-1)
        else:
            x = torch.randint(-128, 128, (n, dim), generator=g, device=dev,
                              dtype=torch.int8)
            a = torch.rand(dim, generator=g, device=dev) * 0.02 + 0.001
            q = torch.randn((BATCH, dim), generator=g, device=dev) * a * 60
            db_sq = (x.float() * a).pow(2).sum(-1)
        args = (x, db_sq, penalty, q)
        lib_ms = library_mm(q.to(torch.bfloat16), x.to(torch.bfloat16).T)
        hold(name, lambda: fused_scan.segment_minima(*args),
             lambda: fused_scan.segment_minima_reference(*args), smi,
             compare="f64", f64=k1_f64(db_sq, penalty, q, x),
             reps=(5, 1), shape=[BATCH, n, dim], library_ms=lib_ms,
             **stage1_bound(BATCH, n, dim, x.element_size(),
                            BATCH * n // 128))
        del x, q, db_sq, args
        torch.cuda.empty_cache()


def exact_dists_ok(res, data: np.ndarray, queries: np.ndarray) -> bool:
    """Each returned (uid, distance) of the first N_ORACLE queries is the
    float64 Euclidean distance of that row, within REL_TOL: stage 2 is
    exact f32 whatever stage 1 selected."""
    for r, qv in zip(res[:N_ORACLE], queries[:N_ORACLE]):
        rows = data[[e.uuid() for e in r[0]]].astype(np.float64)
        want = np.sqrt(((rows - qv.astype(np.float64)) ** 2).sum(1))
        if not np.allclose(r[1], want, rtol=REL_TOL, atol=0.0):
            return False
    return True


def flat_phases(smi: str, dev) -> list:
    """Phases 2 and 3; returns K1's f32 (highest, split3, native) and bf16
    rows of the kernels line."""
    import torch
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import fused_scan

    # -- 2. kernels vs plain versions at the main path's shapes ----------
    n_pad = 1 << 20
    g = torch.Generator(device=dev).manual_seed(0)
    db = torch.rand((n_pad, DIM), generator=g, device=dev) * 218.0
    q = torch.rand((BATCH, DIM), generator=g, device=dev) * 218.0
    dead = torch.rand(n_pad, generator=g, device=dev) < 0.01
    dead[5 * 128:6 * 128] = True      # one wholly dead segment
    valid = ~dead
    penalty = torch.where(dead, float("inf"), 0.0)
    db_sq = (db * db).sum(-1)

    # The exact f32 form, "highest": FFMA on the CUDA cores.
    def plain():
        return fused_scan.segment_minima_reference(db, db_sq, penalty, q,
                                                   precision="highest")

    def kernel():
        return fused_scan.segment_minima(db, db_sq, penalty, q,
                                         precision="highest")

    ref = plain()
    out = kernel()
    torch.cuda.synchronize()
    inf_match = bool(torch.equal(torch.isinf(ref), torch.isinf(out)))
    fin = torch.isfinite(ref)
    max_abs_err = (out - ref)[fin].abs().max().item()
    scale = ref[fin].abs().max().item()
    # Independent check: the first N_ORACLE queries in float64.
    q64 = q[:N_ORACLE].double()
    exact = ((db_sq.double() - 2.0 * (q64 @ db.double().T))
             + penalty.double()).view(N_ORACLE, -1, 128).amin(-1)
    f64_err = (out[:N_ORACLE].double() - exact)[fin[:N_ORACLE]] \
        .abs().max().item()
    del q64, exact, ref, out, fin
    plain(), kernel()                                      # warm-up
    t_plain = [cuda_ms(plain, 10)]
    t_kernel = [cuda_ms(kernel, 10), cuda_ms(kernel, 10)]
    t_plain.append(cuda_ms(plain, 10))
    ok = (inf_match and max_abs_err <= REL_TOL * scale
          and f64_err <= REL_TOL * scale)
    emit("kernel", kernel="segment_minima", dtype="float32",
         precision="highest", shape=[BATCH, n_pad, DIM],
         max_abs_err=max_abs_err,
         f64_max_abs_err=f64_err, score_scale=scale,
         tol=REL_TOL * scale, inf_match=inf_match,
         ms=t_kernel, plain_ms=t_plain, card=smi, ok=ok)
    if not ok:
        raise RuntimeError("segment_minima float32 disagrees with its plain "
                           "version")
    f32_k1 = (max_abs_err, statistics.mean(t_kernel),
              statistics.mean(t_plain))
    k1_library_ms = library_mm(q, db.T)
    # The f32 forms on the tensor cores: split3 against float64 over the
    # f32 rows and the query as it is; native against float64 over both
    # rounded to bf16.
    split_k1 = {}
    for precision in ("split3", "native"):
        split_k1[precision] = hold(
            f"segment_minima_f32_{precision}",
            lambda p=precision: fused_scan.segment_minima(
                db, db_sq, penalty, q, precision=p),
            lambda p=precision: fused_scan.segment_minima_reference(
                db, db_sq, penalty, q, precision=p),
            smi, compare="f64",
            f64=k1_f64(db_sq, penalty, q,
                       db if precision == "split3"
                       else db.to(torch.bfloat16),
                       q_bf16=precision == "native"),
            shape=[BATCH, n_pad, DIM], library_ms=k1_library_ms)
    # A small-magnitude hold at the same shapes: the rows scaled by
    # 2^-126, so nearly every lo part is a bf16 subnormal; the tensor
    # cores must take them as the plain version's f32 products do.
    tiny = db * 2.0 ** -126
    tiny_sq = (tiny * tiny).sum(-1)
    hold("segment_minima_f32_split3_small",
         lambda: fused_scan.segment_minima(tiny, tiny_sq, penalty, q),
         lambda: fused_scan.segment_minima_reference(tiny, tiny_sq,
                                                     penalty, q),
         smi, compare="plain", reps=(3, 1), shape=[BATCH, n_pad, DIM])
    del tiny, tiny_sq
    # The bf16 form on the tensor cores, on the bf16-rounded rows.
    xb = db.to(torch.bfloat16)
    bf16_k1 = hold(
        "segment_minima_bf16",
        lambda: fused_scan.segment_minima(xb, db_sq, penalty, q),
        lambda: fused_scan.segment_minima_reference(xb, db_sq, penalty, q),
        smi, compare="f64", f64=k1_f64(db_sq, penalty, q, xb),
        shape=[BATCH, n_pad, DIM])
    bf16_library_ms = library_mm(q.to(torch.bfloat16), xb.T)
    del xb
    k1_wide(smi, dev)
    # Stage 2 (plain PyTorch) and the segment selection at the same shapes,
    # over split3's minima (the store's default).
    minima = fused_scan.segment_minima(db, db_sq, penalty, q)
    s_keep = fused_scan.segments_kept(K, n_pad)
    sid = fused_scan.select_segments(minima, s_keep)
    fused_scan.rerank_segments(db, valid, q, sid, k=K)     # warm-up
    select_ms = cuda_ms(lambda: fused_scan.select_segments(minima, s_keep),
                        10)
    stage2_ms = cuda_ms(lambda: fused_scan.rerank_segments(
        db, valid, q, sid, k=K), 10)
    # The whole of flat_topk_fused, as store.knn calls it by default:
    # penalty, stage 1 (split3), selection and stage 2.
    fused_ms = cuda_ms(lambda: fused_scan.flat_topk_fused(
        db, db_sq, valid, q, k=K), 10)
    emit("stages", shape=[BATCH, n_pad, DIM], k=K, stage1="split3",
         stage1_ms=split_k1["split3"][1], stage1_highest_ms=f32_k1[1],
         select_ms=select_ms, stage2_ms=stage2_ms,
         flat_topk_fused_ms=fused_ms, card=smi)
    del db, q, dead, valid, penalty, db_sq, minima, sid
    torch.cuda.empty_cache()

    # -- 3. main path through the public API ------------------------------
    data, queries = flat_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(N_MAIN)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(BATCH)]
    truth = oracle_topk(data, queries[:N_ORACLE], K, "euclidean")

    torch.cuda.reset_peak_memory_stats(dev)
    index = FlatNearestNeighborsIndex(metric="euclidean", device="cuda")
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    # The default stage 1 (SMQTK_TPU_STAGE1 unset: split3), then three
    # batches under each other mode: the store reads it per query.
    # highest must also reach recall 1.0; native (one bf16 pass) must
    # return exact distances of the rows it finds, its recall is read.
    launches = {}
    for stage1, n_batches, form in ((None, 5, "wgmma_split3"),
                                    ("highest", 3, "ffma"),
                                    ("native", 3, "wgmma_native")):
        if stage1 is not None:
            os.environ["SMQTK_TPU_STAGE1"] = stage1
        try:
            res, batch_s, split_ms, counts = flat_batches(index, q_elems,
                                                          n_batches)
            self_res = index.nn_many(elems[:BATCH], K)
        finally:
            os.environ.pop("SMQTK_TPU_STAGE1", None)
        k1 = {key: n for key, n in counts.items()
              if key.startswith("segment_minima:") and n}
        launches[form] = k1.get(f"segment_minima:{form}", 0)
        found = [[e.uuid() for e in r[0]] for r in res[:N_ORACLE]]
        rec = recall(found, truth)
        self_ok = all(r[0][0].uuid() == i and r[1][0] == 0.0
                      for i, r in enumerate(self_res))
        finite = all(len(r[0]) == K and np.all(np.isfinite(r[1]))
                     for r in res)
        exact = exact_dists_ok(res, data, queries)
        emit("main", metric="euclidean", dtype="float32",
             stage1=stage1 or "split3 (default)", n=N_MAIN, d=DIM,
             batch=BATCH, k=K, build_s=build_s, batch_s=batch_s,
             qps=BATCH / statistics.median(batch_s), split_ms=split_ms,
             recall_at_10=rec, launches=k1, self_queries_ok=self_ok,
             finite=finite, exact_dists=exact,
             peak_device_bytes=torch.cuda.max_memory_allocated(dev),
             card=smi)
        if k1 != {f"segment_minima:{form}": n_batches}:
            raise RuntimeError(f"flat f32 under {stage1}: K1 launched "
                               f"{k1}, not {form} once a batch")
        if not (self_ok and finite and exact
                and (rec == 1.0 or form == "wgmma_native")):
            raise RuntimeError(f"main path under {stage1}: wrong results")
    del index, self_res, res

    small = data[:N_SMALL]
    small_elems = elems[:N_SMALL]
    q_small = q_elems[:B_SMALL]
    for metric in ("inner_product", "cosine"):
        index = FlatNearestNeighborsIndex(metric=metric, device="cuda")
        t0 = time.perf_counter()
        index.build_index(small_elems)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = index.nn_many(q_small, K)
        query_s = time.perf_counter() - t0
        truth = oracle_topk(small, queries[:B_SMALL], K, metric)
        rec = recall([[e.uuid() for e in r[0]] for r in res], truth)
        emit("main", metric=metric, dtype="float32", n=N_SMALL, d=DIM,
             batch=B_SMALL, k=K, build_s=build_s, first_batch_s=query_s,
             recall_at_10=rec, card=smi)
        if rec != 1.0:
            raise RuntimeError(f"{metric}: recall {rec} != 1.0")
        del index
    # The flat bf16 path at the main path's size: K1's bf16 form on the
    # tensor cores; recall@10 against float64 over the bf16 rows.
    bf16_data = torch.from_numpy(data).to(torch.bfloat16).float().numpy()
    index = FlatNearestNeighborsIndex(metric="euclidean", dtype="bfloat16",
                                      device="cuda")
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    res, batch_s, split_ms, counts = flat_batches(index, q_elems, 3)
    truth = oracle_topk(bf16_data, queries[:N_ORACLE], K, "euclidean")
    rec = recall([[e.uuid() for e in r[0]] for r in res[:N_ORACLE]], truth)
    bf16_launches = counts["segment_minima:wgmma"]
    emit("main", metric="euclidean", dtype="bfloat16", n=N_MAIN, d=DIM,
         batch=BATCH, k=K, build_s=build_s, batch_s=batch_s,
         qps=BATCH / statistics.median(batch_s), split_ms=split_ms,
         recall_at_10=rec, launches=bf16_launches, card=smi)
    if rec != 1.0:
        raise RuntimeError(f"flat bfloat16: recall {rec} != 1.0")
    del index, res, bf16_data
    if bf16_launches == 0:
        raise RuntimeError("the flat bf16 path never launched "
                           "segment_minima")
    err, ms, plain_ms = f32_k1
    source = "smqtk_indexing_tpu_torch/csrc/"
    rows = [{"name": "segment_minima", "route": "cuda",
             "source": source + "segment_minima.cu",
             "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:173",
             "precision": "highest", "launches": launches["ffma"],
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             **stage1_bound(BATCH, n_pad, DIM, 4, BATCH * n_pad // 128,
                            exact_f32=True),
             "library_ms": k1_library_ms, "shape": [BATCH, n_pad, DIM]}]
    for precision, passes in (("split3", 3), ("native", 1)):
        err, ms, plain_ms = split_k1[precision]
        rows.append({
            "name": f"segment_minima_f32_{precision}", "route": "cuda",
            "source": source + "segment_minima_wgmma.cu",
            "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:173",
            "precision": precision,
            "launches": launches[f"wgmma_{precision}"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **stage1_bound(BATCH, n_pad, DIM, 4, BATCH * n_pad // 128,
                           passes=passes),
            "library_ms": k1_library_ms, "shape": [BATCH, n_pad, DIM]})
    return rows + [
            {"name": "segment_minima_bf16", "route": "cuda",
             "source": source + "segment_minima_wgmma.cu",
             "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:173",
             "launches": bf16_launches, "max_abs_err": bf16_k1[0],
             "ms": bf16_k1[1], "plain_ms": bf16_k1[2],
             **stage1_bound(BATCH, n_pad, DIM, 2, BATCH * n_pad // 128),
             "library_ms": bf16_library_ms, "shape": [BATCH, n_pad, DIM]}]


def ivf_data():
    """bench.py's serving-line recipe (bench.py:183-190): a clustered
    Deep1M-shaped mixture, 1,024 held-out queries."""
    rng = np.random.default_rng(2)
    total = IVF_N + IVF_BATCH
    centers = rng.random((1024, IVF_DIM), dtype=np.float32)
    pts = centers[rng.integers(0, 1024, size=total)]
    pts += rng.normal(size=(total, IVF_DIM)).astype(np.float32) / 12
    pts = np.clip(pts, 0, 1).astype(np.float32)[rng.permutation(total)]
    return pts[:IVF_N], pts[IVF_N:]


def _f64_tiled(db3, s2t, t, ti, c0, lo, hi):
    """K7's scores in float64 for the first N_ORACLE queries, and the sum
    of each score's absolute terms."""
    import torch
    from smqtk_indexing_tpu_torch.ops.ivf_scan import W_TILED
    dev = db3.device
    lane = torch.arange(W_TILED, device=dev)
    dims = torch.arange(db3.shape[1], device=dev)
    exact, mag = [], []
    for q0 in range(0, N_ORACLE, 8):
        tt = ti[q0:q0 + 8].long()[..., None]
        cols = c0[q0:q0 + 8].long()[..., None] + lane
        u = db3[tt[..., None], dims[:, None], cols[..., None, :]].double()
        prod = u * t[q0:q0 + 8, None, :, None].double()
        s2 = s2t[tt, 0, cols].double()
        ok = (lane >= lo[q0:q0 + 8, :, None]) & (lane < hi[q0:q0 + 8, :,
                                                          None])
        exact.append(torch.where(ok, s2 - 2.0 * prod.sum(2), float("inf")))
        mag.append(torch.where(ok, s2 + 2.0 * prod.abs().sum(2),
                               float("inf")))
        del u, prod
    return torch.cat(exact), torch.cat(mag)


def _f64_rows(db, t, a, starts, lo, hi, n_q: int = N_ORACLE):
    """K6's scores in float64 for the first ``n_q`` queries, and the sum
    of each score's absolute terms; dead slots read nothing and are
    +inf, the live ones go 16 at a time."""
    import torch
    from smqtk_indexing_tpu_torch.ops.ivf_scan import L_MAX
    lane = torch.arange(L_MAX, device=db.device)
    shape = (n_q, starts.shape[1], L_MAX)
    exact = torch.full(shape, math.inf, dtype=torch.float64,
                       device=db.device)
    mag = torch.full_like(exact, math.inf)
    qi, pi = torch.nonzero(hi[:n_q] > lo[:n_q], as_tuple=True)
    for s0 in range(0, qi.numel(), 16):
        bq, bp = qi[s0:s0 + 16], pi[s0:s0 + 16]
        u = db[starts[bq, bp, None].long() + lane].double()  # (s, L, d)
        au2 = ((u * a.double()) ** 2).sum(-1)
        prod = u * t[bq, None, :].double()
        ok = (lane >= lo[bq, bp, None]) & (lane < hi[bq, bp, None])
        exact[bq, bp] = torch.where(ok, au2 - 2.0 * prod.sum(-1), math.inf)
        mag[bq, bp] = torch.where(ok, au2 + 2.0 * prod.abs().sum(-1),
                                  math.inf)
        del u, prod
    return exact, mag


def _timed_batches(index, q_elems, n_batches: int,
                   spans=("ivf.query", "ivf.assemble")):
    """``nn_many`` over all of ``q_elems`` ``n_batches`` times; (results of
    the last, per-batch seconds, the mean ms of each of ``spans`` over the
    batches)."""
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS
    COUNTERS.reset()
    batch_s = []
    for _ in range(n_batches):
        t0 = time.perf_counter()
        res = index.nn_many(q_elems, K)
        batch_s.append(time.perf_counter() - t0)
    counts = COUNTERS.snapshot()
    split_ms = {name: 1e3 * counts[f"span.{name}.seconds"]
                / counts[f"span.{name}.calls"]
                for name in spans}
    return res, batch_s, split_ms


def _checked(res, truth, n_q: int) -> float:
    """recall@10 of ``res`` against the float64 ids, after checking the
    results' shape and that every distance is finite and sorted."""
    if len(res) != n_q or not all(
            len(r[0]) == K and np.all(np.isfinite(r[1]))
            and list(r[1]) == sorted(r[1]) for r in res):
        raise RuntimeError("IVF results are short, unsorted or not finite")
    return recall([[e.uuid() for e in r[0]] for r in res[:N_ORACLE]],
                  truth)


def ivf_phases(smi: str, dev) -> list:
    """Phases 4 and 5; returns the kernels line's rows of K7, K3 and K6."""
    import torch
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import fused_scan, ivf_scan
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS

    data, queries = ivf_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(IVF_N)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(IVF_BATCH)]
    truth = oracle_topk(data, queries[:N_ORACLE], K, "euclidean")

    # -- 4. the serving line -------------------------------------------
    torch.cuda.reset_peak_memory_stats(dev)

    def make():
        return IvfNearestNeighborsIndex(
            n_lists=IVF_LISTS, nprobe=IVF_NPROBE, kmeans_iterations=10,
            max_points_per_centroid=64, random_seed=0, dtype="sq8",
            storage="code", rerank="score", device="cuda")
    index = make()
    COUNTERS.reset()
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    train_s = COUNTERS.snapshot().get("span.ivf.train.seconds")
    build_peak = torch.cuda.max_memory_allocated(dev)
    d_pad = index._centroids_np.shape[1]
    qd = torch.from_numpy(np.pad(queries, ((0, 0), (0, d_pad - IVF_DIM)))) \
        .to(dev)
    t, ti, c0, lo, hi = ivf_scan.tiled_windows(
        index._sq8_a, index._sq8_b, index._dev_centroids, index._slot_table,
        index._v_tile, index._v_col, index._v_len, qd,
        nprobe_orig=IVF_NPROBE)
    k7_args = (index._dev3, index._s2t, t, ti, c0, lo, hi)
    n_tiles_k7, d_k7, tile_k7 = index._dev3.shape
    cols, pairs = distinct_positions(
        ti.long() * tile_k7 + c0.long(), lo, hi, ivf_scan.W_TILED,
        n_tiles_k7 * tile_k7)
    k7_bound = bound(cols * (d_k7 + 4) + 4 * t.numel() + 16 * ti.numel()
                     + 4 * ti.numel() * ivf_scan.W_TILED,
                     2.0 * d_k7 * pairs, FP32_FLOPS)
    k7_live = int((hi > lo).sum())
    k7 = hold("ivf_list_scores_tiled",
              lambda: ivf_scan.ivf_list_scores_tiled(*k7_args),
              lambda: ivf_scan.ivf_list_scores_tiled_reference(*k7_args),
              smi, compare="f64", f64=lambda: _f64_tiled(*k7_args),
              shape=[IVF_BATCH, ti.shape[1], ivf_scan.W_TILED],
              live_slots=k7_live)
    # K3 on the winner segments the exact re-rank gathers: the top k + 8
    # of those scores (k rounds up to 16 in the index).
    scores = ivf_scan.ivf_list_scores_tiled(*k7_args).reshape(IVF_BATCH, -1)
    _, sel = fused_scan.topk_smallest(scores, 16 + 8)
    base = ti.long() * ivf_scan.TILE_ROWS + c0.long()
    rows = torch.gather(base, 1, sel // ivf_scan.W_TILED) \
        + sel % ivf_scan.W_TILED
    sid = rows // fused_scan.SEG
    k3 = hold("seg_gather_tiled",
              lambda: fused_scan.seg_gather_tiled(index._dev3, sid),
              lambda: fused_scan.seg_gather_tiled_reference(index._dev3,
                                                            sid),
              smi, compare="equal",
              shape=list(sid.shape) + [d_pad, fused_scan.SEG])
    # K3 reads each distinct segment once and writes every gathered one.
    seg_bytes = d_pad * fused_scan.SEG * index._dev3.element_size()
    k3_bound = bound(torch.unique(sid).numel() * seg_bytes
                     + sid.numel() * (seg_bytes + 8), 0.0, FP32_FLOPS)
    k3_library_ms = library_gather(index._dev3, sid)
    del scores, sel, rows, k7_args, t, ti, c0, lo, hi

    index_bytes = torch.cuda.memory_allocated(dev)
    index.nn_many(q_elems, K)                              # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res, batch_s, split_ms = _timed_batches(index, q_elems, 5)
    counts = read_counts()
    rec = _checked(res, truth, IVF_BATCH)
    emit("main", path="ivf serving line", n=IVF_N, d=IVF_DIM,
         n_lists=IVF_LISTS, nprobe=IVF_NPROBE, dtype="sq8",
         storage="code", rerank="score", batch=IVF_BATCH, k=K,
         build_s=build_s, train_s=train_s, batch_s=batch_s,
         qps=IVF_BATCH / statistics.median(batch_s), split_ms=split_ms,
         recall_at_10=rec, launches=counts, index_device_bytes=index_bytes,
         peak_device_bytes_queries=torch.cuda.max_memory_allocated(dev),
         peak_device_bytes_build=build_peak, card=smi)
    if rec < IVF_RECALL_FLOOR:
        raise RuntimeError(f"serving line: recall@10 {rec} < "
                           f"{IVF_RECALL_FLOOR}")
    k7_launches = counts["ivf_list_scores_tiled"]
    rebuilt_equal("ivf serving line", index, make, elems, q_elems, smi)

    index.rerank = "exact"
    index.nn_many(q_elems, K)                              # warm-up
    reset_counts()
    res, batch_s, split_ms = _timed_batches(index, q_elems, 2)
    counts = read_counts()
    rec_exact = _checked(res, truth, IVF_BATCH)
    emit("main", path="ivf serving line, rerank=exact", batch=IVF_BATCH,
         k=K, batch_s=batch_s,
         qps=IVF_BATCH / statistics.median(batch_s), split_ms=split_ms,
         recall_at_10=rec_exact, launches=counts, card=smi)
    if rec_exact < rec - 0.01:
        raise RuntimeError(f"rerank=exact: recall@10 {rec_exact} < score "
                           f"mode's {rec} - 0.01")
    k3_launches = counts["seg_gather_tiled:copy"]
    del index, res
    torch.cuda.empty_cache()

    # -- 5. the rows tier ----------------------------------------------
    # K6's forms: f32 and int8 on their indexes' paths, bf16 on the f32
    # index's rows cast to bf16 (held on the f32 path's operands, then
    # driven through two batches on the cast rows).
    k6 = {}
    for dtype in ("float32", "sq8"):
        index = IvfNearestNeighborsIndex(
            n_lists=IVF_LISTS, nprobe=IVF_NPROBE, kmeans_iterations=10,
            max_points_per_centroid=64, random_seed=0, dtype=dtype,
            device="cuda")
        t0 = time.perf_counter()
        index.build_index(elems)
        build_s = time.perf_counter() - t0
        if not index._dma_eligible():
            raise RuntimeError(f"rows tier {dtype}: not served by K6")
        n_probe, nprobe_orig, first_virt = index._probe_plan()
        dq = (index._sq8_a, index._sq8_b) if dtype == "sq8" else None
        t, a, starts, lo, hi = ivf_scan.row_windows(
            index._dev, index._dev_centroids, index._dev_offsets,
            index._dev_lens, qd, n_probe=n_probe, first_virt=first_virt,
            nprobe_orig=nprobe_orig, dq=dq)
        rows_read, pairs = distinct_positions(
            starts, lo, hi, ivf_scan.L_MAX, index._dev.shape[0])
        form = "ivf_list_scores_f32" if dtype == "float32" \
            else "ivf_list_scores_i8"
        forms = [(form, index._dev)]
        if dtype == "float32":
            forms.append(("ivf_list_scores_bf16",
                          index._dev.to(torch.bfloat16)))
        for name, db in forms:
            k6_args = (db, t, a, starts, lo, hi)
            live = int((hi > lo).sum())
            k6[name] = {
                "hold": hold(
                    name, lambda: ivf_scan.ivf_list_scores(*k6_args),
                    lambda: ivf_scan.ivf_list_scores_reference(*k6_args),
                    smi, compare="f64", f64=lambda: _f64_rows(*k6_args),
                    dtype=str(db.dtype),
                    shape=[IVF_BATCH, n_probe, ivf_scan.L_MAX],
                    live_slots=live),
                "bound": bound(
                    rows_read * db.shape[1] * db.element_size()
                    + 4 * (t.numel() + a.numel()) + 12 * starts.numel()
                    + 4 * starts.numel() * ivf_scan.L_MAX,
                    2.0 * db.shape[1] * pairs, FP32_FLOPS),
                "live_slots": live, "launches": 0}
            del k6_args, db
        del forms, t, a, starts, lo, hi
        index.nn_many(q_elems, K)                          # warm-up
        reset_counts()
        res, batch_s, split_ms = _timed_batches(index, q_elems, 2)
        counts = read_counts()
        k6[form]["launches"] += counts["ivf_list_scores"]
        rec = _checked(res, truth, IVF_BATCH)
        emit("main", path=f"ivf rows tier {dtype}", n=IVF_N, d=IVF_DIM,
             n_lists=IVF_LISTS, nprobe=IVF_NPROBE, batch=IVF_BATCH, k=K,
             build_s=build_s, batch_s=batch_s,
             qps=IVF_BATCH / statistics.median(batch_s), split_ms=split_ms,
             recall_at_10=rec, launches=counts, card=smi)
        if dtype == "float32":
            # Exhaustive probe: every sublist, so the exact top-k.
            index.nprobe = IVF_LISTS
            reset_counts()
            t0 = time.perf_counter()
            res = index.nn_many(q_elems[:N_ORACLE], K)
            ex_s = time.perf_counter() - t0
            counts = read_counts()
            k6[form]["launches"] += counts["ivf_list_scores"]
            rec_ex = _checked(res, truth, N_ORACLE)
            emit("main", path="ivf rows tier float32, nprobe=n_lists",
                 batch=N_ORACLE, k=K, batch_s=[ex_s], recall_at_10=rec_ex,
                 launches=counts, card=smi)
            if rec_ex != 1.0:
                raise RuntimeError(f"exhaustive rows tier: recall@10 "
                                   f"{rec_ex} != 1.0")
            # The same index over its rows cast to bf16: K6's bf16 form.
            index.nprobe = IVF_NPROBE
            index._dev = index._dev.to(torch.bfloat16)
            index.nn_many(q_elems, K)                      # warm-up
            reset_counts()
            res, batch_s, split_ms = _timed_batches(index, q_elems, 2)
            counts = read_counts()
            k6["ivf_list_scores_bf16"]["launches"] += \
                counts["ivf_list_scores"]
            rec_bf16 = _checked(res, truth, IVF_BATCH)
            emit("main", path="ivf rows tier float32 rows cast to bf16",
                 nprobe=IVF_NPROBE, batch=IVF_BATCH, k=K, batch_s=batch_s,
                 qps=IVF_BATCH / statistics.median(batch_s),
                 split_ms=split_ms, recall_at_10=rec_bf16, launches=counts,
                 card=smi)
            if rec_bf16 < rec - 0.02:
                raise RuntimeError(f"rows tier bf16: recall@10 {rec_bf16} "
                                   f"< float32's {rec} - 0.02")
        del index, res
        torch.cuda.empty_cache()

    for name, n in (("ivf_list_scores_tiled", k7_launches),
                    ("seg_gather_tiled", k3_launches),
                    *((name, row["launches"]) for name, row in k6.items())):
        if n == 0:
            raise RuntimeError(f"the IVF paths never launched {name}")
    return [
        {"name": "ivf_list_scores_tiled", "route": "cuda",
         "source": "smqtk_indexing_tpu_torch/csrc/ivf_list_scores_tiled.cu",
         "replaces": "smqtk_indexing_tpu/ops/pallas_ivf.py:469",
         "launches": k7_launches, "max_abs_err": k7[0], "ms": k7[1],
         "plain_ms": k7[2], **k7_bound, "library_ms": None,
         "share": k7_bound["bound_ms"] / k7[1], "live_slots": k7_live},
        {"name": "seg_gather_tiled", "route": "cuda",
         "source": "smqtk_indexing_tpu_torch/csrc/seg_gather.cu",
         "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:406",
         "launches": k3_launches, "max_abs_err": k3[0], "ms": k3[1],
         "plain_ms": k3[2], **k3_bound, "library_ms": k3_library_ms},
    ] + [
        {"name": name, "route": "cuda",
         "source": "smqtk_indexing_tpu_torch/csrc/ivf_list_scores.cu",
         "replaces": "smqtk_indexing_tpu/ops/pallas_ivf.py:128",
         "launches": row["launches"], "max_abs_err": row["hold"][0],
         "ms": row["hold"][1], "plain_ms": row["hold"][2], **row["bound"],
         "library_ms": None, "share": row["bound"]["bound_ms"]
         / row["hold"][1], "live_slots": row["live_slots"]}
        for name, row in k6.items()]


def pq_data():
    """bench_all.py's correlated recipe (bench_all.py:65-85; rank 8, seed
    2, scale 1.0): a 1,024-cluster mixture in a rank-8 latent space mixed
    into 96 dims, 1,024 held-out queries."""
    rng = np.random.default_rng(2)
    n_clusters, rank, scale = 1024, 8, 1.0
    total = IVF_N + IVF_BATCH
    lat = rng.random((n_clusters, rank), dtype=np.float32) * scale
    w = rng.standard_normal((rank, IVF_DIM)).astype(np.float32) \
        / np.sqrt(rank)
    z = lat[rng.integers(0, n_clusters, size=total)]
    z += rng.normal(size=(total, rank)).astype(np.float32) * (scale / 12)
    pts = (z @ w + rng.normal(size=(total, IVF_DIM)).astype(np.float32)
           * (scale / 50)).astype(np.float32)
    pts = pts[rng.permutation(total)]
    return pts[:IVF_N], pts[IVF_N:]


def topk64(x64, q64, k: int, valid=None):
    """Float64 euclidean top-k (rows, distances) on the card, over the
    rows ``valid`` marks live."""
    import torch
    d2 = (q64 * q64).sum(1)[:, None] - 2.0 * (q64 @ x64.T) \
        + (x64 * x64).sum(1)[None, :]
    if valid is not None:
        d2 = torch.where(valid[None, :], d2, float("inf"))
    d2, rows = torch.topk(d2, k, dim=1, largest=False, sorted=True)
    return rows.cpu().numpy(), np.sqrt(np.maximum(d2.cpu().numpy(), 0.0))


def same_topk(uids, dists, ref_uids, ref_dists, what: str) -> None:
    """The top-k of each query equals the reference's: distances within
    RECON_TOL (relative and absolute), and ids that differ only where
    they tie with the k-th distance within the same tolerance."""
    dists = np.asarray(dists, np.float64)
    ok = np.allclose(dists, ref_dists, rtol=RECON_TOL, atol=RECON_TOL)
    for i in range(ref_uids.shape[0]):
        kth = float(ref_dists[i, -1])
        look = dict(zip(ref_uids[i].tolist(), ref_dists[i].tolist()))
        look.update(zip(list(uids[i]), dists[i].tolist()))
        for u in set(uids[i]) ^ set(ref_uids[i].tolist()):
            ok = ok and abs(look[u] - kth) <= RECON_TOL * (1.0 + abs(kth))
    if not ok:
        raise RuntimeError(f"{what}: the top-k is not the reference's "
                           "(beyond near ties)")


def _f64_tiled_pq(db3c, s2t, lut, ti, c0, lo, hi):
    """K8's scores in float64 for the first N_ORACLE queries, and the sum
    of each score's absolute terms."""
    import torch
    from smqtk_indexing_tpu_torch.ops.ivf_scan import W_TILED
    dev = db3c.device
    lane = torch.arange(W_TILED, device=dev)
    subs = torch.arange(db3c.shape[1], device=dev)
    p = ti.shape[1]
    exact, mag = [], []
    for q0 in range(0, N_ORACLE, 8):
        tt = ti[q0:q0 + 8].long()[..., None]
        cols = c0[q0:q0 + 8].long()[..., None] + lane
        codes = db3c[tt[..., None], subs[:, None], cols[..., None, :]]
        idx = subs[:, None] * 256 + codes.long()        # (8, P, M, W)
        vals = torch.gather(
            lut[q0:q0 + 8].double()[:, None, :].expand(-1, p, -1), 2,
            idx.flatten(2)).view(idx.shape)
        s2 = s2t[tt, 0, cols].double()
        ok = (lane >= lo[q0:q0 + 8, :, None]) & (lane < hi[q0:q0 + 8, :,
                                                          None])
        exact.append(torch.where(ok, s2 - 2.0 * vals.sum(2), float("inf")))
        mag.append(torch.where(ok, s2.abs() + 2.0 * vals.abs().sum(2),
                               float("inf")))
        del codes, idx, vals
    return torch.cat(exact), torch.cat(mag)


def _pq_recon64(index, dev):
    """The code tier's reconstructions in float64 on the card, in the
    codec space (residual: the list centroid added back), and the float64
    query transform to that space."""
    import torch
    from smqtk_indexing_tpu_torch.ops.pq import _dequant
    n = index._host.shape[0]
    codes = torch.from_numpy(index._host).to(dev)
    x = _dequant(codes, index._cb_dev).double()
    if index.pq_residual:
        x += index._cents_codec_dev.double()[index._row2list_dev[:n].long()]
    transform = index._perm_dev

    def prep(q_pad):
        q = torch.from_numpy(q_pad).to(dev).double()
        d_codec = transform.shape[0]
        q = torch.nn.functional.pad(q, (0, d_codec - q.shape[1]))
        return q @ transform.double() if transform.dim() == 2 \
            else q[:, transform.long()]
    return x, prep


def ivf_pq_phases(smi: str, dev) -> list:
    """Phases 6 and 7: the IVF-PQ code tier (K8, K3) and the routed rows
    tier (K8); returns the kernels line's row of K8 and the K3 launches."""
    import torch
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import ivf_scan

    data, queries = pq_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(IVF_N)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(IVF_BATCH)]
    truth = oracle_topk(data, queries[:N_ORACLE], K, "euclidean")

    # -- 6. 'OPQ16,IVF4096,PQ16' by_residual, code tier --------------------
    torch.cuda.reset_peak_memory_stats(dev)

    def make():
        return IvfNearestNeighborsIndex(
            n_lists=IVF_LISTS, nprobe=PQ_NPROBE, kmeans_iterations=10,
            max_points_per_centroid=64, random_seed=0, dtype="opq16",
            storage="code", pq_residual=True, rerank="exact",
            device="cuda")
    index = make()
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated(dev)
    d_pad = index._centroids_np.shape[1]
    q_pad = np.pad(queries, ((0, 0), (0, d_pad - IVF_DIM)))
    _, lut, ti, c0, lo, hi, _ = ivf_scan.tiled_windows_pq(
        index._cb_dev, index._perm_dev, index._dev_centroids,
        index._slot_table, index._v_tile, index._v_col, index._v_len,
        torch.from_numpy(q_pad).to(dev), nprobe_orig=PQ_NPROBE,
        residual=True)
    k8_args = (index._dev3, index._s2t, lut, ti, c0, lo, hi)
    n_tiles_k8, m_k8, tile_k8 = index._dev3.shape
    cols, pairs = distinct_positions(
        ti.long() * tile_k8 + c0.long(), lo, hi, ivf_scan.W_TILED,
        n_tiles_k8 * tile_k8)
    k8_bound = bound(cols * (m_k8 + 4) + 4 * lut.numel() + 16 * ti.numel()
                     + 4 * ti.numel() * ivf_scan.W_TILED,
                     float(m_k8) * pairs, FP32_FLOPS)
    k8 = hold("ivf_list_scores_tiled_pq",
              lambda: ivf_scan.ivf_list_scores_tiled_pq(*k8_args),
              lambda: ivf_scan.ivf_list_scores_tiled_pq_reference(*k8_args),
              smi, compare="f64", f64=lambda: _f64_tiled_pq(*k8_args),
              shape=[IVF_BATCH, ti.shape[1], ivf_scan.W_TILED],
              m_sub=int(index._dev3.shape[1]),
              live_slots=int((hi > lo).sum()))
    del k8_args, lut, ti, c0, lo, hi
    index_bytes = torch.cuda.memory_allocated(dev)
    index.nn_many(q_elems, K)                              # warm-up
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res, batch_s, split_ms = _timed_batches(index, q_elems, 5)
    counts = read_counts()
    rec = _checked(res, truth, IVF_BATCH)
    emit("main", path="ivf-pq code tier", n=IVF_N, d=IVF_DIM,
         n_lists=IVF_LISTS, nprobe=PQ_NPROBE, dtype="opq16",
         storage="code", pq_residual=True, rerank="exact", batch=IVF_BATCH,
         k=K, build_s=build_s, batch_s=batch_s,
         qps=IVF_BATCH / statistics.median(batch_s), split_ms=split_ms,
         recall_at_10=rec, launches=counts, index_device_bytes=index_bytes,
         peak_device_bytes_queries=torch.cuda.max_memory_allocated(dev),
         peak_device_bytes_build=build_peak, card=smi)
    if rec < PQ_RECALL_FLOOR:
        raise RuntimeError(f"ivf-pq code tier: recall@10 {rec} < "
                           f"{PQ_RECALL_FLOOR}")
    k8_launches = counts["ivf_list_scores_tiled_pq"]
    k3_launches = counts["seg_gather_tiled:copy"]
    if k3_launches == 0:
        raise RuntimeError("the PQ exact re-rank never launched "
                           "seg_gather_tiled")
    rebuilt_equal("ivf-pq code tier (opq16, residual)", index, make, elems,
                  q_elems, smi)

    index.rerank = "score"
    index.nn_many(q_elems, K)                              # warm-up
    reset_counts()
    res, batch_s, split_ms = _timed_batches(index, q_elems, 2)
    counts = read_counts()
    rec_score = _checked(res, truth, IVF_BATCH)
    emit("main", path="ivf-pq code tier, rerank=score", batch=IVF_BATCH,
         k=K, batch_s=batch_s, qps=IVF_BATCH / statistics.median(batch_s),
         split_ms=split_ms, recall_at_10=rec_score, launches=counts,
         card=smi)
    if rec_score < rec - 0.01:
        raise RuntimeError(f"rerank=score: recall@10 {rec_score} < exact "
                           f"mode's {rec} - 0.01")
    k8_launches += counts["ivf_list_scores_tiled_pq"]

    # Exhaustive probe: the float64 top-k over the index's own
    # reconstructions (the exactness contract, whatever the codec).
    index.rerank = "exact"
    index.nprobe = IVF_LISTS
    reset_counts()
    t0 = time.perf_counter()
    res = index.nn_many(q_elems[:N_ORACLE], K)
    ex_s = time.perf_counter() - t0
    counts = read_counts()
    k8_launches += counts["ivf_list_scores_tiled_pq"]
    k3_launches += counts["seg_gather_tiled:copy"]
    _checked(res, truth, N_ORACLE)
    x64, prep = _pq_recon64(index, dev)
    rows, ref_d = topk64(x64, prep(q_pad[:N_ORACLE]), K)
    del x64
    uids = np.array(index._row2uid, dtype=object)[rows]
    same_topk([[e.uuid() for e in r[0]] for r in res],
              np.array([r[1] for r in res]), uids, ref_d,
              "ivf-pq exhaustive probe")
    emit("main", path="ivf-pq code tier, nprobe=n_lists", batch=N_ORACLE,
         k=K, batch_s=[ex_s], equals_f64_over_reconstructions=True,
         launches=counts, card=smi)
    del index, res
    torch.cuda.empty_cache()

    # -- 7. residual PQ16 on the rows tier: routed to K8 ------------------
    index = IvfNearestNeighborsIndex(
        n_lists=IVF_LISTS, nprobe=PQ_ROWS_NPROBE, kmeans_iterations=10,
        max_points_per_centroid=64, random_seed=0, dtype="pq16",
        storage="rows", pq_residual=True, device="cuda")
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    if index._dev3 is None:
        raise RuntimeError("rows-tier pq16: not routed to the tiled engine")
    index.nn_many(q_elems, K)                              # warm-up
    reset_counts()
    res, batch_s, split_ms = _timed_batches(index, q_elems, 2)
    counts = read_counts()
    k8_launches += counts["ivf_list_scores_tiled_pq"]
    rec = _checked(res, truth, IVF_BATCH)
    emit("main", path="ivf-pq rows tier", n=IVF_N, d=IVF_DIM,
         n_lists=IVF_LISTS, nprobe=PQ_ROWS_NPROBE, dtype="pq16",
         storage="rows", pq_residual=True, batch=IVF_BATCH, k=K,
         build_s=build_s, batch_s=batch_s,
         qps=IVF_BATCH / statistics.median(batch_s), split_ms=split_ms,
         recall_at_10=rec, launches=counts, card=smi)
    if rec < PQ_ROWS_RECALL_FLOOR:
        raise RuntimeError(f"ivf-pq rows tier: recall@10 {rec} < "
                           f"{PQ_ROWS_RECALL_FLOOR}")
    del index, res, elems
    torch.cuda.empty_cache()
    if k8_launches == 0:
        raise RuntimeError("the IVF-PQ paths never launched "
                           "ivf_list_scores_tiled_pq")
    return [{"name": "ivf_list_scores_tiled_pq", "route": "cuda",
             "source": "smqtk_indexing_tpu_torch/csrc/"
                       "ivf_list_scores_tiled_pq.cu",
             "replaces": "smqtk_indexing_tpu/ops/pallas_ivf.py:785",
             "launches": k8_launches, "max_abs_err": k8[0], "ms": k8[1],
             "plain_ms": k8[2], **k8_bound, "library_ms": None}], \
        k3_launches


def flat_codec_phases(smi: str, dev) -> list:
    """Phase 8: the flat SQ8 store (K1's int8 form, and its int8 x int8
    form under ``SMQTK_TPU_SQ8_I8DOT=1``) and the flat PQ16 store over the
    flat phase's vectors; returns the kernels line's rows of K1's int8 and
    int8 x int8 forms."""
    import torch
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import fused_scan
    from smqtk_indexing_tpu_torch.ops.pq import _dequant, pq_prep_queries
    from smqtk_indexing_tpu_torch.ops.sq8 import _i8dot_q, sq8_decode

    data, queries = flat_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(N_MAIN)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(BATCH)]
    truth = oracle_topk(data, queries[:N_ORACLE], K, "euclidean")
    rows_out = []

    for dtype in ("sq8", "pq16"):
        index = FlatNearestNeighborsIndex(dtype=dtype, device="cuda")
        t0 = time.perf_counter()
        index.build_index(elems)
        build_s = time.perf_counter() - t0
        store = index._store
        if dtype == "sq8":
            if not store._sq8_fused_eligible("euclidean"):
                raise RuntimeError("flat sq8: not served by K1's int8 form")
            # K1's int8 form on the store's operands: the codes, their
            # stats and the euclidean query fold (q - b) a.
            qd = torch.from_numpy(queries).to(dev)
            t = (qd - store._sq8_b) * store._sq8_a
            penalty = torch.where(store._dev_valid, 0.0, float("inf"))
            k1_args = (store._dev, store._dev_sq, penalty, t)
            n_i8, d_i8 = store._dev.shape
            shape = [BATCH, n_i8, d_i8]
            err, ms, plain_ms = hold(
                "segment_minima_i8", lambda: fused_scan.segment_minima(
                    *k1_args), lambda: fused_scan.segment_minima_reference(
                    *k1_args), smi, compare="f64",
                f64=k1_f64(store._dev_sq, penalty, t, store._dev),
                shape=shape)
            rows_out.append({
                "name": "segment_minima_i8", "route": "cuda",
                "source":
                    "smqtk_indexing_tpu_torch/csrc/segment_minima_wgmma.cu",
                "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:173",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **stage1_bound(BATCH, n_i8, d_i8, 1, BATCH * n_i8 // 128),
                "library_ms": library_mm(t.to(torch.bfloat16),
                                         store._dev.to(torch.bfloat16).T),
                "shape": shape})
            # Its int8 x int8 form on the operands the store's i8dot
            # makes: the fold quantised with one scale g, the stats / g.
            t_i8, sq_i8 = _i8dot_q(t, store._dev_sq)
            k1_i8_args = (store._dev, sq_i8, penalty, t_i8)
            err, ms, plain_ms = hold(
                "segment_minima_i8i8", lambda: fused_scan.segment_minima(
                    *k1_i8_args), lambda: fused_scan.segment_minima_reference(
                    *k1_i8_args), smi, compare="equal", shape=shape)
            rows_out.append({
                "name": "segment_minima_i8i8", "route": "cuda",
                "source":
                    "smqtk_indexing_tpu_torch/csrc/segment_minima_wgmma.cu",
                "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:173",
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                **stage1_bound(BATCH, n_i8, d_i8, 1, BATCH * n_i8 // 128,
                               int8_query=True),
                "library_ms": library_mm(t_i8, store._dev.T),
                "shape": shape})
            del k1_args, k1_i8_args, t, t_i8, sq_i8, penalty, qd
            x64 = sq8_decode(store._dev, store._sq8_a, store._sq8_b).double()
            q64 = torch.from_numpy(queries[:N_ORACLE]).to(dev).double()
        else:
            perm, rot, _ = store._codec
            x64 = _dequant(store._dev, store._pq_cb_dev).double()
            q64 = torch.from_numpy(pq_prep_queries(
                queries[:N_ORACLE], perm, rot)).to(dev).double()
        rows, ref_d = topk64(x64, q64, K, valid=store._dev_valid)
        del x64, q64
        ref_uids = np.array(store._row2uid, dtype=object)[rows]
        runs = [("", {})]
        if dtype == "sq8":
            runs.append((", SMQTK_TPU_SQ8_I8DOT=1",
                         {"SMQTK_TPU_SQ8_I8DOT": "1"}))
        for tag, env in runs:
            os.environ.update(env)
            try:
                res, batch_s, split_ms, counts = flat_batches(
                    index, q_elems, 3)
            finally:
                for key in env:
                    del os.environ[key]
            same_topk([[e.uuid() for e in r[0]] for r in res[:N_ORACLE]],
                      np.array([r[1] for r in res[:N_ORACLE]]), ref_uids,
                      ref_d, f"flat {dtype}{tag}")
            rec = recall([[e.uuid() for e in r[0]] for r in res[:N_ORACLE]],
                         truth)
            emit("main", path=f"flat {dtype}{tag}", n=N_MAIN, d=DIM,
                 batch=BATCH, k=K, build_s=build_s, batch_s=batch_s,
                 qps=BATCH / statistics.median(batch_s), split_ms=split_ms,
                 recall_at_10_vs_raw=rec,
                 equals_f64_over_quantized_rows=True, launches=counts,
                 card=smi)
            if dtype != "sq8":
                continue
            # Every K1 launch of the batches took the run's form.
            form = "wgmma_s8" if env else "wgmma"
            name = f"segment_minima:{form}"
            k1 = {f: counts[f"segment_minima:{f}"]
                  for f in ("ffma", "wgmma", "wgmma_s8")}
            if k1[form] == 0 or sum(k1.values()) != k1[form]:
                raise RuntimeError(f"flat sq8{tag}: stage 1 did not take "
                                   f"{form}: {k1}")
            rows_out[1 if env else 0]["launches"] = counts[name]
        del index, res, store
        torch.cuda.empty_cache()
    return rows_out


def probe_phase(smi: str, dev) -> list:
    """Phase 9: the K10 probe; returns the kernels line's rows of its two
    arms."""
    import torch
    from smqtk_indexing_tpu_torch.tools import probe_int8_mxu as k10

    t0 = time.perf_counter()
    inputs = k10.make_inputs(dev)
    torch.cuda.synchronize()
    db_t, sq, pen, g = inputs["db_t"], inputs["sq"], inputs["pen"], \
        inputs["g"]
    d, n = db_t.shape
    b = inputs["q_i8"].shape[0]
    emit("k10 inputs", rows=n, d=d, batch=b, g=g,
         seconds=time.perf_counter() - t0, card=smi)

    def f64_bf16():
        """The bf16 arm's minima in float64 for the first N_ORACLE queries
        on the kernel's operands, and the largest sum of absolute terms."""
        qq = inputs["q_bf"][:N_ORACLE].double()
        exact = torch.empty((N_ORACLE, n // 128), dtype=torch.float64,
                            device=dev)
        mag = 0.0
        step = 1 << 20
        for lo in range(0, n, step):
            u = db_t[:, lo:lo + step].double()
            s = sq[lo:lo + step].double()
            exact[:, lo // 128:(lo + step) // 128] = (
                (s - 2.0 * (qq @ u)) + pen[lo:lo + step].double()) \
                .view(N_ORACLE, -1, 128).amin(-1)
            mag = max(mag, (s.max() + 2.0 * (qq.abs() @ u.abs()).max())
                      .item())
            del u
        return exact, torch.full_like(exact, mag)

    rows = []
    for arm, q, int8dot, f64 in (("int8dot", inputs["q_i8"], True, None),
                                 ("bf16", inputs["q_bf"], False, f64_bf16)):
        args = (db_t, sq, pen, q, g)
        err, ms, plain_ms = hold(
            f"scan_minima {arm}",
            lambda: k10.scan_minima(*args, int8dot=int8dot),
            lambda: k10.scan_minima_reference(*args, int8dot=int8dot),
            smi, compare="equal" if int8dot else "f64", f64=f64,
            reps=(10, 2), shape=[b, n, d])
        lib = (q, db_t) if int8dot \
            else (q.to(torch.bfloat16), db_t.to(torch.bfloat16))
        rows.append({
            "name": f"scan_minima_{arm}", "route": "cuda",
            "source":
                "smqtk_indexing_tpu_torch/csrc/segment_minima_tiled_wgmma.cu",
            "replaces": "tools/probe_int8_mxu.py:65",
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            **stage1_bound(b, n, d, 1, b * n // 128, int8_query=int8dot),
            "library_ms": library_mm(*lib), "shape": [b, n, d]})
        del lib
        torch.cuda.empty_cache()
    reset_counts()
    res = k10.run(inputs)
    counts = read_counts()
    emit("main", path="k10 probe, tools/probe_int8_mxu", rows=n, d=d,
         batch=b, **res, launches=counts, card=smi)
    for row in rows:
        arm = row["name"].split("_")[-1]
        row["launches"] = counts[f"scan_minima:{arm}"]
        if row["launches"] == 0:
            raise RuntimeError(f"the K10 probe never launched its {arm} arm")
    del inputs, db_t, sq, pen
    torch.cuda.empty_cache()
    return rows


def k9_bound(variant: str, b: int, n: int, d: int, out_elems: int,
             int8_query: bool, tile_n: int) -> dict:
    """A K9 variant's bound: what its function needs. full and bf16min
    need K2's bytes and products; folded no penalty; nomin only the first
    tile_n / 128 rows of each tile; nodot only each row's first byte and
    no products."""
    q_bytes = (1 if int8_query else 4) * b * d
    peak = INT8_OPS if int8_query else BF16_FLOPS
    if variant == "nodot":
        return bound(n + 8 * n + 4 * out_elems, 0.0, peak)
    if variant == "nomin":
        rows = n // tile_n * (tile_n // 128)
        return bound(rows * (d + 8) + q_bytes + 4 * out_elems,
                     2.0 * b * rows * d, peak)
    stats = 4 * n if variant == "folded" else 8 * n
    return bound(n * d + stats + q_bytes + 4 * out_elems, 2.0 * b * n * d,
                 peak)


def capacity_phases(smi: str, dev) -> list:
    """Phase 10: the 100M-row SQ8 capacity scan, flag off and with
    ``i8dot``, and the K9 probe on it; returns the kernels line's rows of
    K2, K4, K5 (both forms) and K9, and the K3 launches."""
    import torch
    from smqtk_indexing_tpu_torch.examples import capacity_100m as capm
    from smqtk_indexing_tpu_torch.ops import fused_scan, sq8
    from smqtk_indexing_tpu_torch.tools import stage1_analysis as k9

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    cap = capm.build(capm.N_TILES, "cuda", seed=0)
    torch.cuda.synchronize()
    n, d = cap.s2.shape[0], capm.D
    emit("capacity build", rows=n, d=d, layout=list(cap.codes.shape),
         seconds=time.perf_counter() - t0,
         resident_bytes=torch.cuda.memory_allocated(dev),
         peak_device_bytes=torch.cuda.max_memory_allocated(dev), card=smi)

    # -- K2, K4, K5 (both forms) and K9 on a prefix, B=128, dead rows ------
    b = capm.B
    n_p = CAP_PREFIX_TILES * fused_scan.TILE_N
    db3 = cap.codes[:CAP_PREFIX_TILES]
    rows = db3.transpose(1, 2).reshape(n_p, d)
    blk = fused_scan.blocked_layout(rows)
    sq = cap.s2[:n_p]
    pen = torch.zeros(n_p, device=dev)
    pen[1000 * 128:1003 * 128] = math.inf          # three dead segments
    pen[::1009] = math.inf
    t = (cap.queries[:b] - cap.b) * cap.a
    tb = t.to(torch.bfloat16)
    t_i8, sq_i8 = sq8._i8dot_q(t, sq)
    n_steps, g, bw = fused_scan.step_shape(CAP_PREFIX_TILES,
                                           fused_scan.TILE_N)

    def f64():
        """The minima in float64 on the kernels' operands (the query
        rounded to bf16), and the largest sum of absolute terms."""
        tq = tb.double()
        exact = torch.empty((b, n_p // 128), dtype=torch.float64,
                            device=dev)
        mag = 0.0
        step = 1 << 18
        for lo in range(0, n_p, step):
            u = rows[lo:lo + step].double()
            s = sq[lo:lo + step].double()
            exact[:, lo // 128:(lo + step) // 128] = (
                (s - 2.0 * (tq @ u.T)) + pen[lo:lo + step].double()) \
                .view(b, -1, 128).amin(-1)
            mag = max(mag, (s.max() + 2.0 * (tq.abs() @ u.abs().T).max())
                      .item())
            del u
        return exact, torch.full_like(exact, mag)

    def f64_steps():
        exact, mag = f64()
        return (exact.view(b, n_steps, g).transpose(0, 1),
                mag.view(b, n_steps, g).transpose(0, 1))

    shape = [b, n_p, d]
    held = {}
    for form, qq, sqq, compare, f64_flat, f64_step in (
            ("", t, sq, "f64", f64, f64_steps),
            (" i8i8", t_i8, sq_i8, "equal", None, None)):
        blk_sq, blk_pen = sqq.view(-1, 128), pen.view(-1, 128)
        held["segment_minima_tiled" + form] = hold(
            "segment_minima_tiled" + form,
            lambda: fused_scan.segment_minima_tiled(db3, sqq, pen, qq),
            lambda: fused_scan.segment_minima_tiled_reference(
                db3, sqq, pen, qq), smi, compare=compare, f64=f64_flat,
            shape=shape)
        held["segment_minima_blocked" + form] = hold(
            "segment_minima_blocked" + form,
            lambda: fused_scan.segment_minima_blocked(blk, blk_sq, blk_pen,
                                                      qq),
            lambda: fused_scan.segment_minima_blocked_reference(
                blk, blk_sq, blk_pen, qq), smi, compare=compare,
            f64=f64_flat, shape=shape)
        held["segment_minima_tiled2" + form] = hold(
            "segment_minima_tiled2" + form,
            lambda: fused_scan.segment_minima_tiled2(db3, sqq, pen, qq)[0],
            lambda: fused_scan.segment_minima_tiled2_reference(
                db3, sqq, pen, qq)[0], smi, compare=compare, f64=f64_step,
            q_axis=1, shape=shape, steps=[n_steps, g, bw])
        m1, m2 = fused_scan.segment_minima_tiled2(db3, sqq, pen, qq)
        _, m2_plain = fused_scan.segment_minima_tiled2_reference(db3, sqq,
                                                                 pen, qq)
        group_min = bool(torch.equal(
            m2, m1.view(n_steps, b, g // bw, bw).amin(-1)))
        inf_match = bool(torch.equal(torch.isinf(m2), torch.isinf(m2_plain)))
        fin = torch.isfinite(m2_plain)
        m2_err = (m2 - m2_plain)[fin].abs().max().item()
        emit("kernel", kernel="segment_minima_tiled2" + form + ", m2",
             equals_group_min_of_m1=group_min, inf_match=inf_match,
             max_abs_err=m2_err, card=smi)
        # A group minimum moves no further than the minima it is taken over.
        if not (group_min and inf_match
                and m2_err <= held["segment_minima_tiled2" + form][0]):
            raise RuntimeError("segment_minima_tiled2: m2 is not the group "
                               "minimum of m1")
        del m1, m2, m2_plain
    library_ms = library_mm(tb, rows.to(torch.bfloat16).T, 10)
    library_i8_ms = library_mm(t_i8, rows.T, 10)
    out_seg = b * n_p // 128
    bounds = {}
    for form, int8_query in (("", False), (" i8i8", True)):
        flat_bound = stage1_bound(b, n_p, d, 1, out_seg,
                                  int8_query=int8_query)
        bounds["segment_minima_tiled" + form] = flat_bound
        bounds["segment_minima_blocked" + form] = flat_bound
        bounds["segment_minima_tiled2" + form] = stage1_bound(
            b, n_p, d, 1, out_seg + out_seg // bw, int8_query=int8_query)

    # K9's variants on the prefix, 8 tiles a step, both query forms, on
    # the tiled kernel's instantiations; production's K2 and K5 times of
    # the same form beside each. full is K2's own instantiation: its
    # output is K2's, bit for bit.
    k9_held = {}
    for query, qq, sqq, form in (("bf16", t, sq, ""),
                                 ("int8", t_i8, sq_i8, " i8i8")):
        full = k9.run_variant(db3, sqq, pen, qq, variant="full", t_step=8)
        k2 = fused_scan.segment_minima_tiled(db3, sqq, pen, qq)
        same = bool(torch.equal(full.transpose(0, 1).reshape(b, -1), k2))
        # bf16min rounds full's scores: min and rounding commute, and the
        # two instantiations take the same products, so its output is
        # full's rounded to bf16, bit for bit.
        bm = k9.run_variant(db3, sqq, pen, qq, variant="bf16min", t_step=8)
        rounded = bool(torch.equal(bm, full.to(torch.bfloat16).float()))
        emit("kernel", kernel=f"stage1_variant full {query}",
             equals_production_k2=same, bf16min_equals_full_rounded=rounded,
             card=smi)
        if not (same and rounded):
            raise RuntimeError(f"K9 full ({query}) is not K2's output, or "
                               "bf16min not full's rounded to bf16")
        del full, k2, bm
        for variant in k9.LAUNCHES:
            k9_held[variant, query] = hold(
                f"stage1_variant {variant} {query}",
                lambda: k9.run_variant(db3, sqq, pen, qq, variant=variant,
                                       t_step=8),
                lambda: k9.run_variant_reference(db3, sqq, pen, qq,
                                                 variant=variant, t_step=8),
                smi, compare="equal" if query == "int8" or variant == "nodot"
                else "plain_bf16" if variant == "bf16min" else "plain",
                shape=shape, t_step=8,
                production_k2_ms=held["segment_minima_tiled" + form][1],
                production_k5_ms=held["segment_minima_tiled2" + form][1])
    del rows
    torch.cuda.empty_cache()

    # -- sq8_topk_blocked at full scale, flag off and i8dot -----------------
    launches = {}
    cap_k5_ms = {}
    _, g_c, bw_c = fused_scan.step_shape(capm.N_TILES, fused_scan.TILE_N)
    for i8dot in (False, True):
        form = "wgmma_s8" if i8dot else "wgmma"
        for batch in (capm.B, capm.B_BIG):
            capm.scan(cap, batch, i8dot=i8dot)             # warm-up
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            reset_counts()
            batch_s = []
            for _ in range(3):
                t0 = time.perf_counter()
                dists, found = capm.scan(cap, batch, i8dot=i8dot)
                torch.cuda.synchronize()
                batch_s.append(time.perf_counter() - t0)
            counts = read_counts()
            peak = torch.cuda.max_memory_allocated(dev)
            for name in (f"segment_minima_tiled2:{form}",
                         "seg_gather_tiled:copy"):
                launches[name] = launches.get(name, 0) + counts[name]
            # Every K5 launch of the three batches took this form.
            k5_forms = {f: counts[f"segment_minima_tiled2:{f}"]
                        for f in ("ffma", "wgmma", "wgmma_s8")}
            if k5_forms[form] != 3 or sum(k5_forms.values()) != 3:
                raise RuntimeError(f"capacity scan B={batch}: K5 launches "
                                   f"{k5_forms}, not 3 of {form}")
            res = capm.check(cap, dists, found)
            well_formed = (tuple(dists.shape) == (batch, capm.K)
                           and bool(torch.isfinite(dists).all())
                           and bool((found >= 0).all())
                           and bool((dists[:, 1:] >= dists[:, :-1]).all()))
            plain = {}
            if batch == capm.B:
                # The plain pipeline (kernels swapped for their plain
                # versions) on the first queries: the same top-k within
                # near ties.
                q16 = cap.queries[:CAP_PLAIN_QUERIES]
                t0 = time.perf_counter()
                with plain_kernels():
                    d_p, r_p = sq8.sq8_topk_blocked(
                        cap.codes, cap.a, cap.b, cap.s2, cap.valid, q16,
                        k=capm.K, i8dot=i8dot)
                torch.cuda.synchronize()
                same_topk(found[:CAP_PLAIN_QUERIES].cpu().numpy(),
                          dists[:CAP_PLAIN_QUERIES].cpu().numpy(),
                          r_p.cpu().numpy(),
                          d_p.cpu().numpy().astype(np.float64),
                          "capacity scan against the plain pipeline")
                plain = {"equals_plain_pipeline_queries": CAP_PLAIN_QUERIES,
                         "plain_pipeline_s": time.perf_counter() - t0}
            reset_counts()
            ms = capm.stages(cap, batch, reps=3, i8dot=i8dot)
            cap_k5_ms[form, batch] = ms["k5"]
            name = f"segment_minima_tiled:{form}"
            launches[name] = launches.get(name, 0) + read_counts()[name]
            cap_bound = stage1_bound(batch, n, d, 1,
                                     batch * (n // 128) * (1 + 1 / bw_c),
                                     int8_query=i8dot)
            med = statistics.median(batch_s)
            emit("main", path="capacity scan, sq8_topk_blocked, tiled"
                 + (", i8dot" if i8dot else ""), rows=n, d=d, batch=batch,
                 k=capm.K, i8dot=i8dot, batch_s=batch_s,
                 batch_ms=1e3 * med, qps=batch / med, **res, **plain,
                 well_formed=well_formed, stages_ms=ms,
                 k5_bound_ms=cap_bound["bound_ms"],
                 k5_bound_by=cap_bound["bound_by"],
                 k5_share_of_bound=cap_bound["bound_ms"] / ms["k5"],
                 launches=counts, peak_device_bytes=peak, card=smi)
            if not (well_formed and res["recall_at_10"] == 1.0
                    and res["planted_to_random_margin"] > 1.0):
                raise RuntimeError(f"capacity scan B={batch} ({form}): "
                                   "wrong results")
            del dists, found
        torch.cuda.empty_cache()

        # The blocked layout end to end, at the prefix (K4).
        valid_p = pen == 0
        q = cap.queries[:b]
        reset_counts()
        t0 = time.perf_counter()
        d_blk, r_blk = sq8.sq8_topk_blocked(blk, cap.a, cap.b, sq, valid_p,
                                            q, k=capm.K, i8dot=i8dot)
        torch.cuda.synchronize()
        blk_s = time.perf_counter() - t0
        counts = read_counts()
        launches[f"segment_minima_blocked:{form}"] = \
            counts[f"segment_minima_blocked:{form}"]
        d_til, r_til = sq8.sq8_topk_blocked(db3, cap.a, cap.b, sq, valid_p,
                                            q, k=capm.K, i8dot=i8dot)
        same_topk(r_blk.cpu().numpy(), d_blk.cpu().numpy(),
                  r_til.cpu().numpy(), d_til.cpu().numpy().astype(np.float64),
                  "blocked layout against the tiled layout")
        live_only = bool(valid_p[r_blk].all())
        emit("main", path="capacity scan, sq8_topk_blocked, blocked, prefix"
             + (", i8dot" if i8dot else ""), rows=n_p, d=d, batch=b,
             k=capm.K, batch_s=[blk_s], equals_tiled_layout=True,
             dead_rows_excluded=live_only, launches=counts, card=smi)
        if not live_only:
            raise RuntimeError("blocked layout: a dead row was returned")

    # -- the K9 sweep on the resident index ------------------------------
    t_c = (cap.queries[:capm.B] - cap.b) * cap.a
    pen_c = torch.zeros(n, device=dev)
    emit("stage1_ideal", rows=n, batch=capm.B, **k9.ideal(n, capm.B),
         card=smi)
    reset_counts()
    t0 = time.perf_counter()
    sweep = k9.sweep(cap.codes, cap.s2, pen_c, t_c)
    t_i8_c, sq_i8_c = sq8._i8dot_q(t_c, cap.s2)
    sweep += k9.sweep(cap.codes, sq_i8_c, pen_c, t_i8_c,
                      variants=("full", "nomin", "nodot"), t_steps=(8,))
    counts = read_counts()
    emit("main", path="k9 sweep, tools/stage1_analysis", rows=n,
         batch=capm.B, seconds=time.perf_counter() - t0, launches=counts,
         card=smi)
    del t_i8_c, sq_i8_c, pen_c
    for name, count in launches.items():
        if count == 0:
            raise RuntimeError(f"the capacity paths never launched {name}")
    del cap, blk, db3, pen, valid_p
    torch.cuda.empty_cache()

    out = []
    src = "smqtk_indexing_tpu_torch/csrc/"
    replaces = {"segment_minima_tiled": 246, "segment_minima_blocked": 491,
                "segment_minima_tiled2": 807}
    for form, kernel in (("", "wgmma"), (" i8i8", "wgmma_s8")):
        for name, line in replaces.items():
            err, ms, plain_ms = held[name + form]
            row = {
                "name": name + form.replace(" ", "_"), "route": "cuda",
                "source": src + "segment_minima_tiled_wgmma.cu",
                "replaces": f"smqtk_indexing_tpu/ops/pallas_scan.py:{line}",
                "launches": launches[f"{name}:{kernel}"], "max_abs_err": err,
                "ms": ms, "plain_ms": plain_ms, **bounds[name + form],
                "library_ms": library_i8_ms if form else library_ms,
                "shape": shape}
            if name == "segment_minima_tiled2":
                row["capacity_ms"] = [cap_k5_ms[kernel, capm.B],
                                      cap_k5_ms[kernel, capm.B_BIG]]
            out.append(row)
    by_metric = {r["metric"]: r["value"] for r in sweep
                 if r["query"] == "bf16"}
    for variant in k9.LAUNCHES:
        err_bf, ms, plain_ms = k9_held[variant, "bf16"]
        err_i8, ms_i8, plain_i8 = k9_held[variant, "int8"]
        out.append({
            "name": f"stage1_variant_{variant}", "route": "cuda",
            "source": src + "segment_minima_tiled_wgmma.cu",
            "replaces": "tools/stage1_analysis.py:166",
            "launches": counts[f"stage1_variant:{variant}"],
            "max_abs_err": max(err_bf, err_i8), "ms": ms,
            "plain_ms": plain_ms,
            **k9_bound(variant, b, n_p, d, out_seg, False,
                       fused_scan.TILE_N),
            "library_ms": None if variant == "nodot" else library_ms,
            "shape": shape, "int8_query_ms": ms_i8,
            "int8_query_plain_ms": plain_i8,
            "production_k2_ms": held["segment_minima_tiled"][1],
            "int8_query_production_k2_ms":
                held["segment_minima_tiled i8i8"][1],
            "capacity_ms": by_metric[f"stage1_{variant}_t8_ms"]})
        if out[-1]["launches"] == 0:
            raise RuntimeError(f"the K9 sweep never launched {variant}")
    return out, launches["seg_gather_tiled:copy"]


#: The hashing / LSH phase: ``bench_all.py``'s LSH record at its size
#: (``bench_all.py:122-175`` and ``:355-420``): 1,000,000 x 128 rows of
#: its rank-None SIFT-shaped mixture, ITQ-128 fitted on a 100,000-row
#: sample in 50 iterations, Hamming top-16 at B=1024, LSH serving at n=10.
LSH_N = 1_000_000
LSH_DIM = 128
LSH_BITS = 128
LSH_QUERIES = 1024
LSH_FIT_SAMPLE = 100_000
LSH_HAMMING_K = 16
LSH_REPS = 5


def lsh_data():
    """``bench_all._load_or_make("sift_base.fvecs", 1_000_000, 128, 218.0,
    seed=0, nq=1024)`` without the file (``bench_all.py:65-91``, rank
    None): 1,024 clusters, noise scale / 12, clipped to [0, scale],
    shuffled; the queries are independent draws from the mixture."""
    scale, n_clusters, total = 218.0, 1024, LSH_N + LSH_QUERIES
    rng = np.random.default_rng(0)
    centers = rng.random((n_clusters, LSH_DIM), dtype=np.float32) * scale
    pts = centers[rng.integers(0, n_clusters, size=total)]
    pts += rng.normal(size=(total, LSH_DIM)).astype(np.float32) \
        * (scale / 12)
    pts = np.clip(pts, 0, scale).astype(np.float32)
    pts = pts[rng.permutation(total)]
    return pts[:LSH_N], pts[LSH_N:]


def popcount_rows(q_packed, table):
    """Hamming distances of packed uint32 codes ``q_packed`` (B, W) to
    ``table`` (N, W), by a byte table on the host: (B, N) int32."""
    lut = np.array([bin(i).count("1") for i in range(256)], dtype=np.int32)
    out = np.empty((q_packed.shape[0], table.shape[0]), dtype=np.int32)
    t8 = table.view(np.uint8)
    for i, qv in enumerate(q_packed.view(np.uint8)):
        out[i] = lut[t8 ^ qv].sum(-1)
    return out


def timed(fn, reps: int, warm: bool = True):
    """(the last result, host seconds of each of ``reps`` calls, after a
    warm-up call unless ``warm`` is False); each call ends in a copy to
    the host."""
    if warm:
        fn()
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        res = fn()
        secs.append(time.perf_counter() - t0)
    return res, secs


def lsh_answer_ok(uids, dists, q64, ham_rows, d_n, x, k) -> bool:
    """One query's LSH answer over the rows of ``x``: every row's code
    within the n-th Hamming distance ``d_n`` (``ham_rows``: each row's
    code distance), distances the float64 ones within REL_TOL, ascending,
    and no row of a code strictly inside ``d_n`` left out with a smaller
    distance than the last one returned."""
    uids = np.asarray(uids, dtype=np.int64)
    must = np.flatnonzero(ham_rows < d_n)
    rows = np.union1d(must, uids)
    exact = dict(zip(rows.tolist(), np.sqrt(
        ((x[rows].astype(np.float64) - q64) ** 2).sum(1)).tolist()))
    want = np.array([exact[u] for u in uids.tolist()])
    ok = (bool((ham_rows[uids] <= d_n).all())
          and np.allclose(dists, want, rtol=REL_TOL, atol=1e-4)
          and list(dists) == sorted(dists)
          and len(set(uids.tolist())) == len(uids)
          and len(uids) >= min(k, len(must)))
    if ok and len(uids) == k:
        left = np.setdiff1d(must, uids)
        ok = all(exact[r] >= dists[-1] - 1e-4 for r in left.tolist())
    return ok


def lsh_phases(smi: str, dev) -> list:
    """Phase 11, hashing and LSH: ITQ-128, the code store's ±1 route (K1's
    bf16 form) against its XOR route and a numpy popcount, K1 alone at the
    Hamming shape, and ``LSHNearestNeighborIndex`` fused and two-call;
    returns the kernels line's row of K1's bf16 form at the Hamming
    shape."""
    import torch
    from smqtk_indexing_tpu_torch import native
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.hash_index.linear import (
        LinearHashIndex,
    )
    from smqtk_indexing_tpu_torch.models.lsh_functor.itq import ItqFunctor
    from smqtk_indexing_tpu_torch.models.nn_index.lsh import (
        LSHNearestNeighborIndex,
    )
    from smqtk_indexing_tpu_torch.ops import fused_scan, itq
    from smqtk_indexing_tpu_torch.ops.hamming import HOST_SCAN_MAX
    from smqtk_indexing_tpu_torch.utils.bits import pack_bit_vectors_u32
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS

    device = str(dev)
    t0 = time.perf_counter()
    data, queries = lsh_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(LSH_N)]
    emit("lsh data", n=LSH_N, d=LSH_DIM, queries=LSH_QUERIES,
         native_available=native.available(),
         seconds=time.perf_counter() - t0, card=smi)
    if not native.available():
        raise RuntimeError("the native host library did not build")

    # -- (a) ITQ-128 and the Hamming engine ------------------------------
    sample = data[np.random.default_rng(0).choice(
        LSH_N, LSH_FIT_SAMPLE, replace=False)]
    functor = ItqFunctor(bit_length=LSH_BITS, random_seed=0, device=device)
    t0 = time.perf_counter()
    functor.fit([DescriptorMemoryElement(i, v)
                 for i, v in enumerate(sample)])
    fit_s = time.perf_counter() - t0
    # The same fit again, warm, on the device arrays alone.
    x_dev = torch.from_numpy(sample).to(dev)
    r_init = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (LSH_BITS, LSH_BITS)).astype(np.float32)).to(dev)
    t0 = time.perf_counter()
    mean_w, _ = itq.itq_fit(x_dev, r_init, bits=LSH_BITS, n_iter=50)
    mean_w.cpu()
    warm_fit_s = time.perf_counter() - t0
    del x_dev
    rot = functor.rotation.double()
    ortho_err = (rot.T @ rot - torch.eye(LSH_BITS, dtype=torch.float64,
                                         device=dev)).abs().max().item()
    codes, hash_s = timed(lambda: functor.get_hash_batch(data), 1)
    q_codes = functor.get_hash_batch(queries)
    balance = codes.mean(0)
    emit("itq", bits=LSH_BITS, sample=LSH_FIT_SAMPLE, iterations=50,
         fit_s=fit_s, warm_fit_s=warm_fit_s, rotation_ortho_err=ortho_err,
         hash_s=hash_s[0], hash_rows_per_s=LSH_N / hash_s[0],
         bit_balance=[float(balance.min()), float(balance.max())],
         card=smi)

    hi = LinearHashIndex(device=device)
    t0 = time.perf_counter()
    hi.build_index(codes)
    hi_build_s = time.perf_counter() - t0
    store = hi._store
    if not (store._mxu_eligible() and store.n_valid > HOST_SCAN_MAX):
        raise RuntimeError(f"hash index capacity {store._capacity}: not "
                           "served by the ±1 route")
    reset_counts()
    (dists_pm1, codes_pm1), knn_s = timed(
        lambda: store.knn(q_codes, LSH_HAMMING_K), LSH_REPS)
    pm1_counts = read_counts()
    k1_ham = pm1_counts["segment_minima:wgmma"]
    if k1_ham != LSH_REPS + 1 or sum(pm1_counts.values()) != k1_ham:
        raise RuntimeError(f"±1 route: launches {pm1_counts}, not K1's "
                           f"bf16 form once a query batch")
    # The same 128 queries on the XOR route of the same store, and a
    # numpy popcount over its host table: equal distances; codes may
    # differ only among those at the 16th distance.
    qo = q_codes[:N_ORACLE]
    os.environ["SMQTK_TPU_NO_MXU_HAMMING"] = "1"
    try:
        (dists_xor, codes_xor), xor_s = timed(
            lambda: store.knn(qo, LSH_HAMMING_K), 1)
    finally:
        os.environ.pop("SMQTK_TPU_NO_MXU_HAMMING", None)
    xor_counts = read_counts()
    if xor_counts != pm1_counts:
        raise RuntimeError("the XOR route launched a kernel")
    table_ham = popcount_rows(pack_bit_vectors_u32(qo), store._host)
    oracle = np.sort(np.partition(table_ham, LSH_HAMMING_K, axis=1)
                     [:, :LSH_HAMMING_K], axis=1)
    same_d = bool(np.array_equal(dists_pm1[:N_ORACLE], oracle)
                  and np.array_equal(dists_xor, oracle))
    codes_ok = True
    for i in range(N_ORACLE):
        below = oracle[i] < oracle[i, -1]
        got = codes_pm1[i]
        codes_ok &= bool(
            np.array_equal((qo[i] ^ got).sum(-1), oracle[i])
            and {c.tobytes() for c in got[below]}
            == {c.tobytes() for c in codes_xor[i][below]})
    emit("hamming", n_codes=store.n_valid, capacity=store._capacity,
         batch=LSH_QUERIES, k=LSH_HAMMING_K, build_s=hi_build_s,
         batch_s=knn_s, qps=LSH_QUERIES / statistics.median(knn_s),
         xor_batch_s_128=xor_s[0],
         launches={key: n for key, n in pm1_counts.items() if n},
         oracle_queries=N_ORACLE,
         distances_equal=same_d, codes_equal_below_kth=codes_ok, card=smi)
    if not (same_d and codes_ok):
        raise RuntimeError("the ±1 route disagrees with the XOR route or "
                           "numpy")

    # K1 alone at the Hamming shape: bit for bit against its plain
    # version (±1 products and their f32 sums are exact integers).
    q_pm1 = torch.zeros((LSH_QUERIES, store._dev_pm1.shape[1]), device=dev)
    q_pm1[:, :LSH_BITS] = torch.from_numpy(q_codes).to(dev).float() * 2 - 1
    pen = torch.where(store._dev_valid, 0.0, math.inf)
    args = (store._dev_pm1, store._dev_pm1_sq, pen, q_pm1)
    n_pad = store._capacity
    ham_lib_ms = library_mm(q_pm1.to(torch.bfloat16), store._dev_pm1.T)
    ham_k1 = hold("segment_minima_bf16_hamming",
                  lambda: fused_scan.segment_minima(*args),
                  lambda: fused_scan.segment_minima_reference(*args), smi,
                  compare="equal", shape=[LSH_QUERIES, n_pad, LSH_BITS],
                  library_ms=ham_lib_ms)
    del args, q_pm1, pen, hi, store
    torch.cuda.empty_cache()

    # -- (b) LSH serving ----------------------------------------------------
    index = LSHNearestNeighborIndex(lsh_functor=functor, device=device,
                                    distance_method="euclidean")
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st = index._fused_ready(K, LSH_QUERIES)
    state_s = time.perf_counter() - t0
    if st is None or st["pm1"] is None:
        raise RuntimeError("LSH: the fused serve is not eligible or not on "
                           "the ±1 engine")
    emit("lsh build", build_s=build_s, fused_state_s=state_s,
         unique_codes=st["n_codes_live"], l_max=st["l_max"],
         rows=len(st["row2elem"]), engine="mxu", card=smi)
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(LSH_QUERIES)]
    # nn_many first asks count(), which sums the bucket sizes over every
    # key of the KV store on the host.
    _, count_s = timed(index.count, 3)
    serve, serve_counts, serve_split = {}, {}, {}
    for path in ("fused", "two_call"):
        if path == "two_call":
            os.environ["SMQTK_TPU_NO_LSH_FUSED"] = "1"
        try:
            for b in (128, LSH_QUERIES):
                def run():
                    return index.nn_many(q_elems[:b], K)
                # The warm-up outside the counts and spans: the two-call
                # path's first query builds its hash index.
                run()
                reset_counts()
                COUNTERS.reset()
                res, secs = timed(run, LSH_REPS if path == "fused" else 2,
                                  warm=False)
                serve[path, b] = (res, secs)
                serve_counts[path, b] = read_counts()["segment_minima:wgmma"]
                serve_split[f"{path}_b{b}"] = split_of_spans(
                    ("lsh.query_batch", "hamming.knn"))
        finally:
            os.environ.pop("SMQTK_TPU_NO_LSH_FUSED", None)
    k1_lsh = sum(serve_counts.values())
    # Checks on the first N_ORACLE queries: each path's answer valid for
    # its choice among codes tied at the 10th Hamming distance; both
    # paths equal where no such tie exists; recall@10 against float64.
    row_packed = pack_bit_vectors_u32(codes)
    q_packed = pack_bit_vectors_u32(q_codes[:N_ORACLE])
    truth = oracle_topk(data, queries[:N_ORACLE], K, "euclidean")
    valid = {"fused": 0, "two_call": 0}
    untied = agree = 0
    for i in range(N_ORACLE):
        ham_rows = popcount_rows(q_packed[i:i + 1], row_packed)[0]
        s = np.partition(table_ham[i], K)[:K + 1]
        s.sort()
        d_n = s[K - 1]
        answers = {}
        for path in valid:
            r = serve[path, LSH_QUERIES][0][i]
            answers[path] = ([e.uuid() for e in r[0]], list(r[1]))
            valid[path] += lsh_answer_ok(*answers[path],
                                         queries[i].astype(np.float64),
                                         ham_rows, d_n, data, K)
        if s[K - 1] < s[K]:
            untied += 1
            (uf, df), (u2, d2) = answers["fused"], answers["two_call"]
            agree += uf == u2 and np.allclose(df, d2, rtol=REL_TOL, atol=0)
    recall10 = {path: recall([[e.uuid() for e in r[0]] for r in
                              serve[path, LSH_QUERIES][0][:N_ORACLE]], truth)
                for path in valid}
    emit("lsh", n=LSH_N, k=K, qps={
        f"{path}_b{b}": b / statistics.median(secs)
        for (path, b), (_, secs) in serve.items()},
        batch_s={f"{path}_b{b}": secs
                 for (path, b), (_, secs) in serve.items()},
        k1_launches={f"{path}_b{b}": n
                     for (path, b), n in serve_counts.items()},
        split_ms=serve_split, count_ms=1e3 * statistics.median(count_s),
        valid_answers=valid, oracle_queries=N_ORACLE,
        untied_queries=untied, fused_equals_two_call_untied=agree,
        recall_at_10=recall10, card=smi)
    if any(n != N_ORACLE for n in valid.values()) or agree != untied:
        raise RuntimeError("LSH: an invalid answer, or the fused and "
                           "two-call paths disagree")
    if any(serve_counts[p, b] == 0 for p, b in serve_counts):
        raise RuntimeError(f"LSH: a path never launched K1: {serve_counts}")
    del index, serve, elems
    torch.cuda.empty_cache()
    err, ms, plain_ms = ham_k1
    return [{"name": "segment_minima_bf16_hamming", "route": "cuda",
             "source": "smqtk_indexing_tpu_torch/csrc/"
                       "segment_minima_wgmma.cu",
             "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:173",
             "launches": k1_ham + k1_lsh, "max_abs_err": err, "ms": ms,
             "plain_ms": plain_ms,
             **stage1_bound(LSH_QUERIES, n_pad, LSH_BITS, 2,
                            LSH_QUERIES * n_pad // 128),
             "library_ms": ham_lib_ms,
             "shape": [LSH_QUERIES, n_pad, LSH_BITS]}]


#: The MRPT phase: ``BASELINE.md``'s config 4 (``docs/benchmarks.md:268-288``,
#: run there at 256K rows) at the GIST1M size: 1,000,000 x 960 rows of
#: ``bench_all.py``'s rank-None mixture (``:44-91``, scale 1.0, seed 4),
#: whose 128 held-out draws give the 64 queries of its MRPT batch
#: (``:424-455``), k=10. (8, 9) takes the mirror (8 trees x 2^20 rows x
#: 1,024 bytes: exactly ``MIRROR_BUDGET``), (16, 7) the gather route (its
#: mirror would take 16 GiB).
MRPT_N = 1_000_000
MRPT_DIM = 960
MRPT_HELD_OUT = 128
MRPT_QUERIES = 64
MRPT_CONFIGS = ((8, 9), (16, 7))
MRPT_REPS = 5
#: Recall@10 of the mirror and the gather route on the same trees may
#: differ by at most this (the SQ8 selection at the rank-k boundary).
MRPT_ROUTE_GAP = 0.02
MRPT_SWITCH = "SMQTK_TPU_NO_MRPT_MIRROR"


def mrpt_data():
    """``bench_all._load_or_make("gist_base.fvecs", 1_000_000, 960, 1.0,
    seed=4)`` without the file (``bench_all.py:65-91``, rank None): 1,024
    clusters in [0, 1]^960, noise 1/12, clipped, shuffled; the first 64 of
    its 128 held-out draws. The noise is drawn in row chunks, the same
    numbers as one call, so no float64 copy of the whole matrix is made."""
    scale, n_clusters = 1.0, 1024
    total = MRPT_N + MRPT_HELD_OUT
    rng = np.random.default_rng(4)
    centers = rng.random((n_clusters, MRPT_DIM), dtype=np.float32) * scale
    pts = centers[rng.integers(0, n_clusters, size=total)]
    for lo in range(0, total, 1 << 16):
        hi = min(lo + (1 << 16), total)
        pts[lo:hi] += rng.normal(size=(hi - lo, MRPT_DIM)) \
            .astype(np.float32) * (scale / 12)
    np.clip(pts, 0, scale, out=pts)
    pts = pts[rng.permutation(total)]
    return pts[:MRPT_N], pts[MRPT_N:MRPT_N + MRPT_QUERIES]


def f64_topk_rows(data: np.ndarray, queries: np.ndarray, k: int, dev,
                  chunk: int = 1 << 16) -> np.ndarray:
    """Float64 top-k row ids over ``data``'s rows, on the card, in row
    chunks (no float64 copy of the whole database)."""
    import torch
    q = torch.from_numpy(queries).to(dev).double()
    q_sq = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], k), math.inf, dtype=torch.float64,
                        device=dev)
    best_i = torch.zeros((q.shape[0], k), dtype=torch.long, device=dev)
    for lo in range(0, data.shape[0], chunk):
        x = torch.from_numpy(data[lo:lo + chunk]).to(dev).double()
        d2 = q_sq + (x * x).sum(1)[None] - 2.0 * (q @ x.T)
        ids = torch.arange(lo, lo + x.shape[0], device=dev) \
            .expand(q.shape[0], -1)
        best_d, sel = torch.topk(torch.cat([best_d, d2], 1), k, dim=1,
                                 largest=False)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, sel)
    return best_i.cpu().numpy()


def mrpt_checked(res, data, queries, truth):
    """(recall@10 against ``truth``, whether every answer is valid: K rows,
    none twice, distances ascending and the float64 ones within REL_TOL
    (atol 1e-4))."""
    ok = len(res) == len(queries)
    for (elems, dists), qv in zip(res, queries):
        uids = np.array([e.uuid() for e in elems], dtype=np.int64)
        exact = np.sqrt(((data[uids].astype(np.float64) - qv) ** 2).sum(1))
        ok = ok and len(uids) == K and len(set(uids.tolist())) == K \
            and list(dists) == sorted(dists) \
            and np.allclose(dists, exact, rtol=REL_TOL, atol=1e-4)
    return recall([[e.uuid() for e in r[0]] for r in res], truth), ok


def mrpt_phases(smi: str, dev) -> list:
    """Phase 12, MRPT at the GIST1M shape: t8/d9 on the mirror (K6's int8
    form, held against its plain version and float64 at the mirror's
    windows), t16/d7 on the gather route, and the t8 payload reloaded
    under ``SMQTK_TPU_NO_MRPT_MIRROR=1`` (the gather route on the same
    trees); returns the kernels line's row of K6 on the mirror."""
    import torch
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (
        MRPTNearestNeighborsIndex,
    )

    device = str(dev)
    t0 = time.perf_counter()
    data, queries = mrpt_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(MRPT_N)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(MRPT_QUERIES)]
    data_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    truth = f64_topk_rows(data, queries, K, dev)
    emit("mrpt data", n=MRPT_N, d=MRPT_DIM, queries=MRPT_QUERIES,
         data_s=data_s, oracle_s=time.perf_counter() - t0, card=smi)

    spans = ("mrpt.query", "mrpt.assemble")
    recalls, k6_row, payload = {}, None, None
    for trees, depth in MRPT_CONFIGS:
        torch.cuda.reset_peak_memory_stats(dev)
        index = MRPTNearestNeighborsIndex(num_trees=trees, depth=depth,
                                          random_seed=0, device=device)
        t0 = time.perf_counter()
        index.build_index(elems)
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated(dev)
        route = "mirror" if index._mirror is not None else "gather"
        want = "mirror" if index.mirror_bytes() \
            <= index.MIRROR_BUDGET else "gather"
        if route != want:
            raise RuntimeError(f"mrpt t{trees}/d{depth}: the {route} route, "
                               f"not the {want} route")
        index.nn_many(q_elems, K)                          # warm-up
        reset_counts()
        res, batch_s, split_ms = _timed_batches(index, q_elems, MRPT_REPS,
                                                spans)
        counts = read_counts()
        rec, ok = mrpt_checked(res, data, queries, truth)
        recalls[trees, depth, route] = rec
        emit("main", path=f"mrpt t{trees}/d{depth} {route} route",
             n=MRPT_N, d=MRPT_DIM, trees=trees, depth=depth,
             leaf_max=index._leaf_max, batch=MRPT_QUERIES, k=K,
             build_s=build_s, mirror_bytes=index.mirror_bytes(),
             mirror_built=route == "mirror", batch_s=batch_s,
             batch_ms=1e3 * statistics.median(batch_s),
             qps=MRPT_QUERIES / statistics.median(batch_s),
             split_ms=split_ms, launches=counts, recall_at_10=rec,
             answers_valid=ok, peak_device_bytes_build=build_peak,
             card=smi)
        k6_launches = counts["ivf_list_scores"]
        if not ok:
            raise RuntimeError(f"mrpt t{trees}/d{depth}: an answer is short, "
                               "repeats a row or misstates a distance")
        if (k6_launches > 0) != (route == "mirror"):
            raise RuntimeError(f"mrpt t{trees}/d{depth} {route} route: K6 "
                               f"launched {k6_launches} times")
        if route == "mirror":
            k6_row = mrpt_k6(index, queries, smi, dev)
            k6_row["launches"] = k6_launches
            index.index_element = DataMemoryElement()
            t0 = time.perf_counter()
            index._save_index()
            save_s = time.perf_counter() - t0
            payload = index.index_element.get_bytes()
            descriptor_set = index.descriptor_set
        del index, res
        torch.cuda.empty_cache()

    # The t8 trees again, from their payload, under the switch: the gather
    # route on the same trees.
    os.environ[MRPT_SWITCH] = "1"
    try:
        t0 = time.perf_counter()
        index = MRPTNearestNeighborsIndex(
            descriptor_set=descriptor_set,
            index_element=DataMemoryElement(payload), num_trees=8, depth=9,
            random_seed=0, device=device)
        load_s = time.perf_counter() - t0
        del payload
        if index._mirror is not None:
            raise RuntimeError(f"{MRPT_SWITCH}=1 still built the mirror")
        index.nn_many(q_elems, K)                          # warm-up
        reset_counts()
        res, batch_s, split_ms = _timed_batches(index, q_elems, MRPT_REPS,
                                                spans)
        counts = read_counts()
    finally:
        os.environ.pop(MRPT_SWITCH)
    rec, ok = mrpt_checked(res, data, queries, truth)
    gap = abs(rec - recalls[8, 9, "mirror"])
    emit("main", path="mrpt t8/d9 payload reloaded, gather route",
         switch=f"{MRPT_SWITCH}=1", save_s=save_s, load_s=load_s,
         batch=MRPT_QUERIES, k=K, batch_s=batch_s,
         batch_ms=1e3 * statistics.median(batch_s),
         qps=MRPT_QUERIES / statistics.median(batch_s), split_ms=split_ms,
         launches=counts, recall_at_10=rec,
         mirror_recall_at_10=recalls[8, 9, "mirror"], recall_gap=gap,
         answers_valid=ok, card=smi)
    if not ok or counts["ivf_list_scores"] or gap > MRPT_ROUTE_GAP:
        raise RuntimeError(f"mrpt reloaded under the switch: valid {ok}, "
                           f"K6 launches {counts['ivf_list_scores']}, "
                           f"recall gap {gap} > {MRPT_ROUTE_GAP}?")
    del index, res, elems, descriptor_set
    torch.cuda.empty_cache()
    return [k6_row]


def mrpt_k6(index, queries, smi: str, dev) -> dict:
    """K6's int8 form at the mirror's windows for the batch's queries, held
    against its plain version and float64 (all 64 queries); the kernels
    line's row but its launches."""
    import torch
    from smqtk_indexing_tpu_torch.ops import ivf_scan, mrpt
    d_pad = index._bases_np.shape[1]
    qd = torch.from_numpy(np.pad(queries, ((0, 0), (0, d_pad - MRPT_DIM)))) \
        .to(dev)
    leaves = mrpt.descend_leaves(
        torch.einsum("bd,tdl->btl", qd, index._dev_bases),
        index._dev_splits, index._depth_eff)
    tn = index._mirror.shape[0]
    starts, lo, hi = mrpt.mirror_windows(index._dev_offsets, leaves,
                                         index._capacity, tn,
                                         index._leaf_max)
    t_q = (qd - index._mir_b) * index._mir_a
    args = (index._mirror, t_q, index._mir_a, starts, lo, hi)
    rows_read, pairs = distinct_positions(starts, lo, hi, ivf_scan.L_MAX, tn)
    live = int((hi > lo).sum())
    shape = [MRPT_QUERIES, starts.shape[1], ivf_scan.L_MAX]
    err, ms, plain_ms = hold(
        "ivf_list_scores_i8_mrpt",
        lambda: ivf_scan.ivf_list_scores(*args),
        lambda: ivf_scan.ivf_list_scores_reference(*args), smi,
        compare="f64",
        f64=lambda: _f64_rows(*args, n_q=MRPT_QUERIES),
        n_f64=MRPT_QUERIES, dtype="torch.int8", shape=shape + [d_pad],
        live_slots=live, rows_read=rows_read, operand_rows=tn,
        operand_bytes=tn * d_pad)
    k6_bound = bound(rows_read * d_pad + 4 * (t_q.numel() + d_pad)
                     + 12 * starts.numel() + 4 * starts.numel()
                     * ivf_scan.L_MAX, 2.0 * d_pad * pairs, FP32_FLOPS)
    return {"name": "ivf_list_scores_i8_mrpt", "route": "cuda",
            "source": "smqtk_indexing_tpu_torch/csrc/ivf_list_scores.cu",
            "replaces": "smqtk_indexing_tpu/ops/pallas_ivf.py:128",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, **k6_bound, "library_ms": None,
            "share": k6_bound["bound_ms"] / ms, "live_slots": live,
            "shape": shape + [d_pad], "operand_bytes": tn * d_pad}


#: What two builds of one IVF configuration from one seed must share, bit
#: for bit: the centroids and the assignment, the codec (SQ8 scale and
#: offset; PQ codebooks; the OPQ rotation), the tiles of codes and row
#: stats, and the slot table.
BUILD_STATE = ("_centroids_np", "_assign_host", "_code_a", "_code_b",
               "_code_cb", "_code_rot", "_dev3", "_s2t", "_slot_table")


def _same_state(a, b, names) -> dict:
    """Attribute by attribute, whether ``a`` and ``b`` hold the same bits
    (tensors, numpy arrays, or None on both)."""
    import torch
    out = {}
    for name in names:
        x, y = getattr(a, name, None), getattr(b, name, None)
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            out[name] = (isinstance(x, torch.Tensor)
                         and isinstance(y, torch.Tensor)
                         and x.shape == y.shape and bool(torch.equal(x, y)))
        elif x is None or y is None:
            out[name] = x is None and y is None
        else:
            out[name] = bool(np.array_equal(np.asarray(x), np.asarray(y)))
    return out


def rebuilt_equal(path: str, index, make, elems, q_elems, smi: str) -> None:
    """Build ``make()`` over ``elems`` a second time, with no determinism
    switch, as a user would, and raise unless its trained state
    (``BUILD_STATE``) and its ``nn_many`` answers (ids and distances)
    equal ``index``'s bit for bit."""
    import torch
    t0 = time.perf_counter()
    again = make()
    again.build_index(elems)
    rebuild_s = time.perf_counter() - t0
    same = _same_state(index, again, BUILD_STATE)
    u1, d1 = _uid_rows(index.nn_many(q_elems, K))
    u2, d2 = _uid_rows(again.nn_many(q_elems, K))
    answers = bool(np.array_equal(u1, u2) and np.array_equal(d1, d2))
    emit("determinism", path=path, rebuild_s=rebuild_s,
         state_bit_equal=same, answers_bit_equal=answers,
         queries=len(q_elems), k=K, card=smi)
    del again
    torch.cuda.empty_cache()
    if not (answers and all(same.values())):
        raise RuntimeError(f"{path}: two builds from one seed differ: "
                           f"{same}, answers equal {answers}")


def front_end_phase(smi: str, dev) -> None:
    """Phase 13, the front ends on the IVF phase's 1M x 96 vectors:
    ``FaissNearestNeighborsIndex`` from a reference-shaped JSON config,
    whose answers must equal ``IvfNearestNeighborsIndex``'s built directly
    with the same parameters, then ``AutotunedNearestNeighborsIndex``'s
    calibration and recall@10."""
    import torch
    from smqtk_indexing_tpu_torch.core.configuration import from_config_dict
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
        NearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.autotune import (
        AutotunedNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    device = str(dev)
    data, queries = ivf_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(IVF_N)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(IVF_BATCH)]
    truth = oracle_topk(data, queries[:N_ORACLE], K, "euclidean")

    # A config written for the reference's FAISS wrapper, unchanged.
    config = {"type": "FaissNearestNeighborsIndex",
              "FaissNearestNeighborsIndex": {
                  "factory_string": f"IVF{IVF_LISTS},SQ8",
                  "metric_type": "l2", "ivf_nprobe": IVF_NPROBE,
                  "random_seed": 0}}
    t0 = time.perf_counter()
    faiss = from_config_dict(config, NearestNeighborsIndex.get_impls())
    faiss.build_index(elems)
    faiss_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    direct = IvfNearestNeighborsIndex(n_lists=IVF_LISTS, nprobe=IVF_NPROBE,
                                      dtype="sq8", random_seed=0,
                                      device=device)
    direct.build_index(elems)
    direct_s = time.perf_counter() - t0
    same_centroids = bool(np.array_equal(faiss._inner._centroids_np,
                                         direct._centroids_np))
    faiss.nn_many(q_elems, K)                              # warm-up
    reset_counts()
    res_f, batch_s, _ = _timed_batches(faiss, q_elems, 2, spans=())
    counts = read_counts()
    res_d = direct.nn_many(q_elems, K)
    equal = all([e.uuid() for e in a[0]] == [e.uuid() for e in b[0]]
                and a[1] == b[1] for a, b in zip(res_f, res_d))
    rec = _checked(res_f, truth, IVF_BATCH)
    emit("main", path=f"faiss adapter 'IVF{IVF_LISTS},SQ8' from a "
         "reference config",
         inner=type(faiss._inner).__name__, inner_device=faiss._inner.device,
         n=IVF_N, d=IVF_DIM, nprobe=faiss._inner.nprobe, build_s=faiss_s,
         direct_build_s=direct_s, same_centroids=same_centroids,
         answers_equal_direct=equal, batch=IVF_BATCH, k=K, batch_s=batch_s,
         qps=IVF_BATCH / statistics.median(batch_s), launches=counts,
         recall_at_10=rec, card=smi)
    if not equal or counts["ivf_list_scores"] == 0:
        raise RuntimeError("faiss adapter: answers differ from the direct "
                           "IVF index's, or K6 never launched")
    del faiss, direct, res_f, res_d
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    auto = AutotunedNearestNeighborsIndex(autotune=True, target_precision=0.95,
                                          random_seed=0, device=device)
    auto.build_index(elems)
    tune_s = time.perf_counter() - t0
    if auto._ivf is None:
        raise RuntimeError("autotune chose the exhaustive scan at 1M rows")
    reset_counts()
    res, batch_s, _ = _timed_batches(auto, q_elems[:N_ORACLE], 2, spans=())
    counts = read_counts()
    rec = _checked(res, truth, N_ORACLE)
    emit("main", path="autotuned index, target_precision=0.95", n=IVF_N,
         d=IVF_DIM, build_and_tune_s=tune_s,
         n_lists=int(auto._ivf._centroids_np.shape[0]),
         nprobe=auto._tuned_nprobe, batch=N_ORACLE, k=K, batch_s=batch_s,
         launches=counts, recall_at_10=rec, card=smi)
    del auto, res, elems
    torch.cuda.empty_cache()


#: The sharded phase: ``BASELINE.md:51``'s config 5 ("Sharded index ...
#: Deep10M, per-chip scan + all-gather top-k merge"): bench.py's clustered
#: recipe (``bench.py:183-190``) at 10,000,000 x 96 with 1,024 held-out
#: queries, over n_devices = 4 shards (four cards where there are four,
#: else four shards of one card).
SHARD_N = 10_000_000
SHARD_DIM = 96
SHARD_BATCH = 1024
SHARD_DEVICES = 4
SHARD_REPS = 3
#: IVF-PQ's held-out recall at nprobe=4 is the codec's (read, no bar).
SHARD_IVF_KW = dict(n_lists=IVF_LISTS, nprobe=IVF_NPROBE,
                    kmeans_iterations=10, max_points_per_centroid=64,
                    random_seed=0, storage="code")


def shard_devices():
    """(device of each shard, which placement): four cards when four are
    visible, else four shards of ``cuda:0``."""
    import torch
    if torch.cuda.device_count() >= SHARD_DEVICES:
        return [f"cuda:{i}" for i in range(SHARD_DEVICES)], "four cards"
    return ["cuda:0"] * SHARD_DEVICES, "four shards of one card"


def sharded_data(dev):
    """bench.py's clustered recipe (1,024 uniform centres in [0, 1]^96,
    Gaussian noise of sigma 1/12, clipped to [0, 1]) at SHARD_N rows plus
    SHARD_BATCH held-out queries, drawn on the card from a
    ``torch.Generator`` seeded 2 in blocks of 2^21 rows, then copied to
    the host: (rows, queries) float32."""
    import torch
    g = torch.Generator(device=dev)
    g.manual_seed(2)
    total = SHARD_N + SHARD_BATCH
    centres = torch.rand((1024, SHARD_DIM), generator=g, device=dev)
    out = np.empty((total, SHARD_DIM), dtype=np.float32)
    for lo in range(0, total, 1 << 21):
        hi = min(lo + (1 << 21), total)
        pick = torch.randint(0, 1024, (hi - lo,), generator=g, device=dev)
        noise = torch.randn((hi - lo, SHARD_DIM), generator=g, device=dev)
        out[lo:hi] = (centres[pick] + noise / 12).clamp_(0, 1).cpu().numpy()
    return out[:SHARD_N], out[SHARD_N:]


def shard_bytes(holder, n_shards: int) -> list:
    """Device bytes of each shard's tensors: every list of ``n_shards``
    tensors among ``holder``'s attributes (sharded or replicated), a
    tensor shared by shards of one card counted for each."""
    import torch
    out = [0] * n_shards
    for value in vars(holder).values():
        if isinstance(value, list) and len(value) == n_shards \
                and all(isinstance(t, torch.Tensor) for t in value):
            for s, t in enumerate(value):
                out[s] += t.numel() * t.element_size()
    return out


def peak_bytes(devs) -> dict:
    """Each card's peak allocated bytes since its last reset."""
    import torch
    return {d: torch.cuda.max_memory_allocated(d) for d in sorted(set(devs))}


def _uid_rows(res):
    """(uids (B, k), distances (B, k) float64) of ``nn_many`` results, or
    such a pair itself."""
    if isinstance(res, tuple):
        return np.asarray(res[0]), np.asarray(res[1], dtype=np.float64)
    return (np.array([[e.uuid() for e in r[0]] for r in res]),
            np.array([r[1] for r in res], dtype=np.float64))


def same_answers(res, ref, what: str, bit_equal: bool) -> dict:
    """``res`` against ``ref``, query by query: the same rows except for
    entries tied with the k-th distance, and at every rank where both
    hold the same row, bit-equal distances (``bit_equal``) or within
    REL_TOL. Raises on a difference; returns the counts."""
    u, d = _uid_rows(res)
    u_r, d_r = _uid_rows(ref)
    if u.shape != u_r.shape:
        raise RuntimeError(f"{what}: result shapes {u.shape} {u_r.shape}")
    same_rank = u == u_r
    if bit_equal:
        ok_d = bool(np.array_equal(d[same_rank], d_r[same_rank]))
    else:
        ok_d = bool(np.allclose(d[same_rank], d_r[same_rank],
                                rtol=REL_TOL, atol=0.0))
    swapped = 0
    for i in range(u.shape[0]):
        kth = float(d_r[i, -1])
        look = dict(zip(u_r[i].tolist(), d_r[i].tolist()))
        look.update(zip(u[i].tolist(), d[i].tolist()))
        for x in set(u[i].tolist()) ^ set(u_r[i].tolist()):
            swapped += 1
            if abs(look[x] - kth) > REL_TOL * (1.0 + abs(kth)):
                raise RuntimeError(f"{what}: row {x} at {look[x]} is not "
                                   f"a tie with the k-th distance {kth}")
    if not ok_d:
        raise RuntimeError(f"{what}: distances of the same rows differ")
    return {"ranks_equal": int(same_rank.sum()), "tie_swaps": swapped,
            "distances_bit_equal": bool(np.array_equal(d[same_rank],
                                                        d_r[same_rank]))}


def _timed_pair(single, sharded, q_elems, spans, devs):
    """Warm each index, then time SHARD_REPS batches of it, the single
    device first; returns per index (results, batch seconds, span split,
    launches, the cards' peak bytes over the queries, each shard's
    launches)."""
    import torch
    out = {}
    for name, index in (("single", single), ("sharded", sharded)):
        index.nn_many(q_elems, K)                          # warm-up
        for d in set(devs):
            torch.cuda.reset_peak_memory_stats(d)
        reset_counts()
        with shard_launches(SHARD_DEVICES) as tallies:
            res, batch_s, split_ms = _timed_batches(
                index, q_elems, SHARD_REPS, spans=spans)
        out[name] = (res, batch_s, split_ms, read_counts(),
                     peak_bytes(devs), tallies)
    return out


def _shard(index, s: int, *names):
    return tuple(getattr(index, n)[s] for n in names)


@contextlib.contextmanager
def shard_launches(n_shards: int):
    """Each shard's kernel launches while the block runs: the launch
    counts read just before and just after each shard's search inside
    ``sharded_topk`` (the body every sharded code-tier query shares),
    the difference added to that shard's tally. Yields the tallies, one
    dict a shard (global shard order)."""
    from smqtk_indexing_tpu_torch.parallel import sharded_ivf_code
    tallies = [{} for _ in range(n_shards)]
    inner = sharded_ivf_code.sharded_topk

    def counting(mesh, k, local):
        def counted(s, kk):
            before = read_counts()
            out = local(s, kk)
            for name, n in read_counts().items():
                if n != before[name]:
                    tallies[s][name] = tallies[s].get(name, 0) \
                        + n - before[name]
            return out
        return inner(mesh, k, counted)

    sharded_ivf_code.sharded_topk = counting
    try:
        yield tallies
    finally:
        sharded_ivf_code.sharded_topk = inner


def _shard_ms(kernel, args) -> float:
    """Mean ms of ``kernel(*args)`` over 10 calls after a warm-up, with
    CUDA events on the card its operands lie on."""
    import torch
    with torch.cuda.device(args[0].device):
        kernel(*args)
        return cuda_ms(lambda: kernel(*args), 10)


def _k7_operands(index, s: int, qd):
    """K7's operands on shard ``s`` of the sharded SQ8 code tier at the
    query batch, its bound and its live slots."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    db3, s2t, a, b, cents, st, vt, vc, vl = _shard(
        index, s, "_dev3", "_s2t", "_sq8_a", "_sq8_b", "_dev_centroids",
        "_slot_table", "_v_tile", "_v_col", "_v_len")
    t, ti, c0, lo, hi = ivf_scan.tiled_windows(
        a, b, cents, st[0], vt[0], vc[0], vl[0], qd.to(db3.device),
        nprobe_orig=IVF_NPROBE)
    n_tiles, d_k7, tile = db3.shape
    cols, pairs = distinct_positions(ti.long() * tile + c0.long(), lo, hi,
                                     ivf_scan.W_TILED, n_tiles * tile)
    k7_bound = bound(cols * (d_k7 + 4) + 4 * t.numel() + 16 * ti.numel()
                     + 4 * ti.numel() * ivf_scan.W_TILED,
                     2.0 * d_k7 * pairs, FP32_FLOPS)
    return (db3, s2t, t, ti, c0, lo, hi), k7_bound, int((hi > lo).sum())


def _k3_operands(k7_args):
    """K3's operands after K7 on one shard (the segments of the best 24
    columns of each query, as the exact re-rank picks them) and bound."""
    import torch
    from smqtk_indexing_tpu_torch.ops import fused_scan, ivf_scan
    db3, ti, c0 = k7_args[0], k7_args[3], k7_args[4]
    scores = ivf_scan.ivf_list_scores_tiled(*k7_args).reshape(
        SHARD_BATCH, -1)
    _, sel = fused_scan.topk_smallest(scores, 16 + 8)
    base = ti.long() * ivf_scan.TILE_ROWS + c0.long()
    sid = (torch.gather(base, 1, sel // ivf_scan.W_TILED)
           + sel % ivf_scan.W_TILED) // fused_scan.SEG
    seg_bytes = db3.shape[1] * fused_scan.SEG * db3.element_size()
    k3_bound = bound(torch.unique(sid).numel() * seg_bytes
                     + sid.numel() * (seg_bytes + 8), 0.0, FP32_FLOPS)
    return (db3, sid), k3_bound


def _k8_operands(index, s: int, qd):
    """K8's operands on shard ``s`` of the sharded PQ16 code tier at the
    query batch, its bound and its live slots."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    db3c, s2t, cb, perm, cents, st, vt, vc, vl = _shard(
        index, s, "_dev3", "_s2t", "_cb_dev", "_perm_dev", "_dev_centroids",
        "_slot_table", "_v_tile", "_v_col", "_v_len")
    _, lut, ti, c0, lo, hi, _ = ivf_scan.tiled_windows_pq(
        cb, perm, cents, st[0], vt[0], vc[0], vl[0], qd.to(db3c.device),
        nprobe_orig=IVF_NPROBE)
    n_tiles, m_k8, tile = db3c.shape
    cols, pairs = distinct_positions(ti.long() * tile + c0.long(), lo, hi,
                                     ivf_scan.W_TILED, n_tiles * tile)
    k8_bound = bound(cols * (m_k8 + 4) + 4 * lut.numel() + 16 * ti.numel()
                     + 4 * ti.numel() * ivf_scan.W_TILED,
                     float(m_k8) * pairs, FP32_FLOPS)
    return (db3c, s2t, lut, ti, c0, lo, hi), k8_bound, int((hi > lo).sum())


def _per_shard(rows: list) -> dict:
    """Each shard's ms, bound, share of the bound (and live slots)."""
    out = {"per_shard_ms": [r["ms"] for r in rows],
           "per_shard_bound_ms": [r["bound_ms"] for r in rows],
           "per_shard_share": [r["bound_ms"] / r["ms"] for r in rows]}
    if "live" in rows[0]:
        out["per_shard_live_slots"] = [r["live"] for r in rows]
    return out


def sharded_k7_k3(index, qd, smi: str) -> tuple:
    """K7 and K3 of the sharded SQ8 code tier at the query batch: held
    against their plain versions (K7 also float64) on shard 0's operands,
    with shard 0's times and bound on the row, and timed with their
    bounds on every shard's own operands; (K7 row fields, K3 row
    fields)."""
    from smqtk_indexing_tpu_torch.ops import fused_scan, ivf_scan
    k7_rows, k3_rows = [], []
    for s in range(SHARD_DEVICES):
        args, k7_bound, live = _k7_operands(index, s, qd)
        g_args, k3_bound = _k3_operands(args)
        k7_rows.append({"ms": _shard_ms(ivf_scan.ivf_list_scores_tiled,
                                        args), "live": live, **k7_bound})
        k3_rows.append({"ms": _shard_ms(fused_scan.seg_gather_tiled,
                                        g_args), **k3_bound})
        if s == 0:
            args0, g_args0, k7_bound0, k3_bound0, live0 = \
                args, g_args, k7_bound, k3_bound, live
    args, g_args = args0, g_args0
    ti = args[3]
    k7 = hold("ivf_list_scores_tiled_shard0",
              lambda: ivf_scan.ivf_list_scores_tiled(*args),
              lambda: ivf_scan.ivf_list_scores_tiled_reference(*args),
              smi, compare="f64", n_f64=N_ORACLE, f64=lambda: _f64_tiled(*args),
              shape=[SHARD_BATCH, ti.shape[1], ivf_scan.W_TILED],
              live_slots=live0, slots=int(ti.numel()),
              **_per_shard(k7_rows))
    db3, sid = g_args
    k3 = hold("seg_gather_tiled_shard0",
              lambda: fused_scan.seg_gather_tiled(*g_args),
              lambda: fused_scan.seg_gather_tiled_reference(*g_args),
              smi, compare="equal",
              shape=list(sid.shape) + [db3.shape[1], fused_scan.SEG],
              **_per_shard(k3_rows))
    k3_lib = library_gather(db3, sid)
    return ({"max_abs_err": k7[0], "ms": k7[1], "plain_ms": k7[2],
             **k7_bound0, "library_ms": None,
             "share": k7_bound0["bound_ms"] / k7[1], "live_slots": live0,
             "slots": int(ti.numel()), **_per_shard(k7_rows)},
            {"max_abs_err": k3[0], "ms": k3[1], "plain_ms": k3[2],
             **k3_bound0, "library_ms": k3_lib,
             "share": k3_bound0["bound_ms"] / k3[1],
             **_per_shard(k3_rows)})


def sharded_k8(index, qd, smi: str) -> dict:
    """K8 of the sharded PQ16 code tier at the query batch: held against
    its plain version and float64 on shard 0's operands, with shard 0's
    time and bound on the row, and timed with its bound on every shard's
    own operands."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    k8_rows = []
    for s in range(SHARD_DEVICES):
        args, k8_bound, live = _k8_operands(index, s, qd)
        k8_rows.append({"ms": _shard_ms(ivf_scan.ivf_list_scores_tiled_pq,
                                        args), "live": live, **k8_bound})
        if s == 0:
            args0, k8_bound0, live0 = args, k8_bound, live
    args = args0
    ti, m_k8 = args[3], args[0].shape[1]
    k8 = hold("ivf_list_scores_tiled_pq_shard0",
              lambda: ivf_scan.ivf_list_scores_tiled_pq(*args),
              lambda: ivf_scan.ivf_list_scores_tiled_pq_reference(*args),
              smi, compare="f64", n_f64=N_ORACLE, f64=lambda: _f64_tiled_pq(*args),
              shape=[SHARD_BATCH, ti.shape[1], ivf_scan.W_TILED],
              m_sub=int(m_k8), live_slots=live0, slots=int(ti.numel()),
              **_per_shard(k8_rows))
    return {"max_abs_err": k8[0], "ms": k8[1], "plain_ms": k8[2],
            **k8_bound0, "library_ms": None,
            "share": k8_bound0["bound_ms"] / k8[1], "live_slots": live0,
            "slots": int(ti.numel()), **_per_shard(k8_rows)}


def sharded_phase(smi: str, dev) -> list:
    """Phase 14, ``sharded-deep10m-shape``; returns the kernels line's rows
    of K7, K3 and K8 on the shards."""
    import torch
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS
    from smqtk_indexing_tpu_torch.data import (
        DataMemoryElement, DescriptorMemoryElement,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    devs, placement = shard_devices()
    emit("sharded placement", phase_name="sharded-deep10m-shape",
         devices=devs, placement=placement,
         cards_visible=torch.cuda.device_count(), card=smi)
    t0 = time.perf_counter()
    data, queries = sharded_data(dev)
    data_s = time.perf_counter() - t0
    # 10M long-lived elements: made with the collector off, then frozen
    # out of its scans (each full collection would walk all of them, in
    # the builds and in every batch's assembly) until the phase ends.
    t0 = time.perf_counter()
    gc.disable()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(SHARD_N)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(SHARD_BATCH)]
    gc.freeze()
    gc.enable()
    elems_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    truth = f64_topk_rows(data, queries[:N_ORACLE], K, dev)
    oracle_s = time.perf_counter() - t0
    emit("sharded data", n=SHARD_N, d=SHARD_DIM, queries=SHARD_BATCH,
         data_s=data_s, elements_s=elems_s, oracle_s=oracle_s, card=smi)

    payload = {}

    def pair(cls, **kw):
        """The single-device index built, then the sharded one loading its
        payload over the same descriptor set (the payload's element kept
        in ``payload["last"]``)."""
        elem = DataMemoryElement()
        payload["last"] = elem
        single = cls(index_element=elem, device=str(dev), **kw)
        COUNTERS.reset()
        t_b = time.perf_counter()
        single.build_index(elems)
        build_s = time.perf_counter() - t_b
        train_s = COUNTERS.snapshot().get("span.ivf.train.seconds")
        t_b = time.perf_counter()
        sharded = cls(index_element=DataMemoryElement(elem.get_bytes()),
                      descriptor_set=single.descriptor_set,
                      n_devices=SHARD_DEVICES, device=devs, **kw)
        load_s = time.perf_counter() - t_b
        single.index_element = sharded.index_element = None
        return single, sharded, {"build_s": build_s, "train_s": train_s,
                                 "sharded_load_s": load_s}

    def report(path, single, sharded, setup, spans, holder, bit_equal,
               **extra):
        runs = _timed_pair(single, sharded, q_elems, spans, devs)
        res_1, res_s = runs["single"][0], runs["sharded"][0]
        match = same_answers(res_s, res_1, path, bit_equal)
        rec = {name: recall([[e.uuid() for e in r[0]]
                             for r in runs[name][0][:N_ORACLE]], truth)
               for name in runs}
        fields = {}
        for name, (_, batch_s, split_ms, counts, peak, _) in runs.items():
            fields[name] = {
                "batch_s": batch_s,
                "qps": SHARD_BATCH / statistics.median(batch_s),
                "split_ms": split_ms, "launches": _nonzero(counts),
                "peak_device_bytes": peak, "recall_at_10": rec[name]}
        per_shard = runs["sharded"][5]
        fields["sharded"]["per_shard_launches"] = per_shard
        emit("main", path=path, phase_name="sharded-deep10m-shape",
             n=SHARD_N, d=SHARD_DIM, batch=SHARD_BATCH, k=K,
             n_devices=SHARD_DEVICES, devices=devs, placement=placement,
             **setup, match=match,
             shard_device_bytes=shard_bytes(holder, SHARD_DEVICES),
             card=smi, **fields, **extra)
        return res_1, res_s, rec, runs["sharded"][3], per_shard

    # -- the flat index ------------------------------------------------
    single, sharded, setup = pair(FlatNearestNeighborsIndex)
    res_1, res_s, rec, _, _ = report(
        "sharded flat", single, sharded, setup,
        ("flat.query", "store.knn", "flat.assemble"), sharded._store,
        bit_equal=False)
    if not exact_dists_ok(res_s, data, queries) or rec["sharded"] != 1.0:
        raise RuntimeError(f"sharded flat: distances are not float64's "
                           f"or recall@10 {rec['sharded']} != 1.0")
    del sharded, res_s
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host_stream_phase(smi, dev, payload.pop("last").get_bytes(),
                      single.descriptor_set, q_elems, res_1)
    emit("seconds", of="host-stream-deep10m-shape phase",
         seconds=time.perf_counter() - t0)
    del single, res_1
    torch.cuda.empty_cache()

    # -- the IVF code tier: SQ8 score (K7), exact (K3), PQ16 (K8) ------
    qd = torch.from_numpy(np.pad(queries, ((0, 0),
                                           (0, 128 - SHARD_DIM)))).to(dev)
    rows = []
    single, sharded, setup = pair(
        IvfNearestNeighborsIndex, dtype="sq8", rerank="score",
        **SHARD_IVF_KW)
    k7, k3 = sharded_k7_k3(sharded, qd, smi)
    _, _, _, counts, per_shard = report(
        "sharded ivf sq8 code tier, rerank=score", single, sharded, setup,
        ("ivf.query", "ivf.assemble"), sharded, bit_equal=True)
    k7_shards = [t.get("ivf_list_scores_tiled", 0) for t in per_shard]
    single.rerank = sharded.rerank = "exact"
    _, _, _, counts_x, per_shard = report(
        "sharded ivf sq8 code tier, rerank=exact", single, sharded,
        {"build_s": 0.0, "train_s": 0.0, "sharded_load_s": 0.0},
        ("ivf.query", "ivf.assemble"), sharded, bit_equal=True)
    k7_shards = [a + t.get("ivf_list_scores_tiled", 0)
                 for a, t in zip(k7_shards, per_shard)]
    k3_shards = [t.get("seg_gather_tiled:copy", 0) for t in per_shard]
    launches = {"K7": (counts["ivf_list_scores_tiled"]
                       + counts_x["ivf_list_scores_tiled"], k7_shards),
                "K3": (counts_x["seg_gather_tiled:copy"], k3_shards)}
    del single, sharded
    torch.cuda.empty_cache()
    single, sharded, setup = pair(
        IvfNearestNeighborsIndex, dtype="pq16", rerank="score",
        **SHARD_IVF_KW)
    k8 = sharded_k8(sharded, qd, smi)
    _, _, _, counts, per_shard = report(
        "sharded ivf pq16 code tier, rerank=score", single, sharded, setup,
        ("ivf.query", "ivf.assemble"), sharded, bit_equal=True)
    launches["K8"] = (counts["ivf_list_scores_tiled_pq"],
                      [t.get("ivf_list_scores_tiled_pq", 0)
                       for t in per_shard])
    del single, sharded, elems
    gc.unfreeze()
    torch.cuda.empty_cache()
    # Every shard runs its search once a batch, so each must have
    # launched each kernel, and the shards' tallies must add up to the
    # whole run's count.
    for name, (n, each) in launches.items():
        if n == 0 or 0 in each or sum(each) != n:
            raise RuntimeError(f"the sharded code tier's {name} launches: "
                               f"{n} in all, {each} by shard")
    src = "smqtk_indexing_tpu_torch/csrc/"
    for name, source, replaces, key, row in (
            ("ivf_list_scores_tiled_sharded", "ivf_list_scores_tiled.cu",
             "pallas_ivf.py:469", "K7", k7),
            ("seg_gather_tiled_sharded", "seg_gather.cu",
             "pallas_scan.py:406", "K3", k3),
            ("ivf_list_scores_tiled_pq_sharded",
             "ivf_list_scores_tiled_pq.cu", "pallas_ivf.py:785", "K8",
             k8)):
        n, each = launches[key]
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": "smqtk_indexing_tpu/ops/" + replaces,
                     "launches": n, **row, "n_devices": SHARD_DEVICES,
                     "placement": placement, "per_shard_launches": each,
                     "timed_on": "max_abs_err, ms, plain_ms and bound_ms: "
                                 "shard 0's operands at B=1024; "
                                 "per_shard_*: each shard's own"})
    return rows


def stream_copy_s(store, reps: int = 2) -> dict:
    """The host-streamed store's block pipeline alone (``store.blocks``:
    staging, copy to the card and padding, every block, no scan; seconds
    on the host clock, mean of ``reps``), and one pinned staging buffer's
    copy to the card alone, between CUDA events."""
    import torch
    dev = store._device
    snap = store.snapshot()[:3]
    t0 = time.perf_counter()
    for _ in range(reps):
        for _block in store.blocks(*snap):
            pass
    torch.cuda.synchronize(dev)
    wall = (time.perf_counter() - t0) / reps
    buf = store._staging[1][0]
    h2d = cuda_ms(lambda: [buf[name].to(dev, non_blocking=True)
                           for name in ("rows", "sq", "valid")], 5)
    blk_bytes = sum(t.numel() * t.element_size()
                    for t in (buf["rows"], buf["sq"], buf["valid"]))
    return {"copy_s": wall, "h2d_block_ms": h2d, "block_bytes": blk_bytes}


def stream_scan_ms(store, q: np.ndarray) -> float:
    """ms of the host-streamed store's per-block scans alone
    (``store.scan_block``, k=K) over its blocks (``store.blocks``) held
    resident on the card, between CUDA events."""
    import torch
    qd = store.device_queries(q)
    blocks = list(store.blocks(*store.snapshot()[:3]))

    def scans():
        for lo, mat, sq, va in blocks:
            store.scan_block(lo, mat, sq, va, qd, K, "euclidean")
    scans()
    ms = cuda_ms(scans, 2)
    del blocks
    torch.cuda.empty_cache()
    return ms


def host_stream_phase(smi: str, dev, payload: bytes, descriptor_set,
                      q_elems, ref) -> None:
    """``host-stream-deep10m-shape``: ``FlatNearestNeighborsIndex(storage=
    "host_stream")`` over the sharded phase's 10M x 96 rows (loaded from
    the single-device flat index's payload, over its descriptor set), three
    B=1,024 batches at k=10; every id and distance must equal the
    single-device index's (``ref``, its answers to the same queries), bit
    for bit, and no kernel may launch (each block runs the plain scan, as
    in JAX). Prints queries/s, the copy's GB/s, the scan's share of a
    batch and the peak device bytes."""
    import torch
    from smqtk_indexing_tpu_torch.data import DataMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS
    t0 = time.perf_counter()
    index = FlatNearestNeighborsIndex(
        index_element=DataMemoryElement(payload),
        descriptor_set=descriptor_set, storage="host_stream",
        device=str(dev))
    index.index_element = None
    load_s = time.perf_counter() - t0
    store = index._store
    index.nn_many(q_elems, K)                              # warm-up
    resident = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    res, batch_s, split_ms = _timed_batches(
        index, q_elems, SHARD_REPS,
        spans=("flat.query", "store.knn", "flat.assemble",
               "host_stream.stage"))
    counts = _nonzero(read_counts())
    peak = torch.cuda.max_memory_allocated(dev)
    streamed = COUNTERS.snapshot()
    blocks = streamed["host_stream.blocks"] / SHARD_REPS
    moved = streamed["host_stream.bytes"] / SHARD_REPS
    staging_s = streamed["span.host_stream.stage.seconds"] / SHARD_REPS
    u, d = _uid_rows(res)
    u_r, d_r = _uid_rows(ref)
    ids_equal = bool(np.array_equal(u, u_r))
    dists_equal = bool(np.array_equal(d, d_r))
    copy = stream_copy_s(store)
    q = np.stack([e.vector() for e in q_elems]).astype(np.float32)
    scan_ms = stream_scan_ms(store, q)
    batch_ms = 1e3 * statistics.median(batch_s)
    emit("main", path="flat host_stream", phase_name=
         "host-stream-deep10m-shape", n=store._host.shape[0],
         d=store._host.shape[1], batch=len(q_elems), k=K,
         blocks=blocks, block_rows=store.BLOCK_ROWS,
         load_s=load_s, batch_s=batch_s,
         qps=len(q_elems) / statistics.median(batch_s), split_ms=split_ms,
         bytes_a_batch=moved, host_staging_s_a_batch=staging_s,
         copy_alone_s=copy["copy_s"],
         copy_gb_s=moved / copy["copy_s"] / 1e9,
         h2d_block_ms=copy["h2d_block_ms"],
         h2d_gb_s=copy["block_bytes"] / copy["h2d_block_ms"] / 1e6,
         scan_alone_ms=scan_ms, scan_share_of_batch=scan_ms / batch_ms,
         peak_device_bytes=peak, resident_bytes_before=resident,
         peak_over_resident_bytes=peak - resident,
         ids_equal_single=ids_equal,
         dists_bit_equal_single=dists_equal, launches=counts, card=smi)
    if not (ids_equal and dists_equal) or counts:
        raise RuntimeError("host stream: answers differ from the "
                           "single-device flat index's, or a kernel "
                           f"launched: {counts}")
    del index, store, res
    torch.cuda.empty_cache()


#: The other sharded routes' query count and LSH sizes.
ROUTE_QUERIES = 128
ROUTE_LSH_N = 200_000
ROUTE_LSH_BITS = 10


def _route(what: str, single_res, sharded_res, launches: dict, smi: str,
           bit_equal: bool = False, **extra) -> None:
    match = same_answers(sharded_res, single_res, what, bit_equal)
    if "single_launches" in extra:
        extra["single_launches"] = _nonzero(extra["single_launches"])
    emit("sharded route", path=what, match=match,
         launches=_nonzero(launches), card=smi, **extra)


def _nonzero(counts: dict) -> dict:
    """The launch counts that are not 0."""
    return {name: n for name, n in counts.items() if n}


def sharded_routes(smi: str, dev) -> None:
    """Phase 15: every other sharded route once on the card, each against
    its single-device counterpart on an earlier phase's data: the IVF rows
    tier (float32 and sq8) on phase 4's 1M x 96 vectors, MRPT t8/d9 on
    them (the gather route on both sides), one ``sharded_kmeans_step``,
    the flat store's sq8 and pq16 on phase 3's 1M x 128 vectors,
    ``LinearHashIndex`` over codes of those vectors, LSH (SimpleRP-10, two
    calls) on 200,000 of phase 4's, and a 2-D (dcn=2) mesh."""
    import torch
    from smqtk_indexing_tpu_torch.data import (
        DataMemoryElement, DescriptorMemoryElement,
    )
    from smqtk_indexing_tpu_torch.models.hash_index.linear import (
        LinearHashIndex,
    )
    from smqtk_indexing_tpu_torch.models.lsh_functor.simple_rp import (
        SimpleRPFunctor,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.lsh import (
        LSHNearestNeighborIndex,
    )
    from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (
        MRPTNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops.kmeans import (
        cell_means, cell_sums, fixed_point_scale, kmeans_assign, to_fixed,
    )
    from smqtk_indexing_tpu_torch.ops.store import VectorStore
    from smqtk_indexing_tpu_torch.parallel import (
        make_mesh, shard_rows, sharded_kmeans_step,
    )

    devs, placement = shard_devices()
    t_all = time.perf_counter()

    def pair(cls, elems, **kw):
        elem = DataMemoryElement()
        single = cls(index_element=elem, device=str(dev), **kw)
        single.build_index(elems)
        sharded = cls(index_element=DataMemoryElement(elem.get_bytes()),
                      descriptor_set=single.descriptor_set,
                      n_devices=SHARD_DEVICES, device=devs, **kw)
        single.index_element = sharded.index_element = None
        return single, sharded

    def run(index, q_elems):
        reset_counts()
        res = index.nn_many(q_elems, K)
        return res, read_counts()

    data, queries = ivf_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(IVF_N)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(ROUTE_QUERIES)]
    for dtype in ("float32", "sq8"):
        single, sharded = pair(IvfNearestNeighborsIndex, elems,
                               n_lists=IVF_LISTS, nprobe=IVF_NPROBE,
                               kmeans_iterations=10,
                               max_points_per_centroid=64, random_seed=0,
                               dtype=dtype)
        res_1, c_1 = run(single, q_elems)
        res_s, c_s = run(sharded, q_elems)
        if c_1["ivf_list_scores"] == 0 or c_s["ivf_list_scores"] != 0:
            raise RuntimeError(f"rows tier {dtype}: K6 must run on one "
                               "device only")
        _route(f"ivf rows tier {dtype}", res_1, res_s, c_s, smi,
               single_launches=c_1)
        del single, sharded
    with _env("SMQTK_TPU_NO_MRPT_MIRROR", "1"):
        single, sharded = pair(MRPTNearestNeighborsIndex, elems,
                               num_trees=8, depth=9, random_seed=0)
    res_1, c_1 = run(single, q_elems)
    res_s, c_s = run(sharded, q_elems)
    if single._mirror is not None or sharded._mesh is None:
        raise RuntimeError("mrpt: both sides must take the gather route")
    _route("mrpt t8/d9, gather route", res_1, res_s, c_s, smi)
    del single, sharded
    # One data-parallel Lloyd step against the same step on one device
    # (the fixed-point sums of all rows at once: the same bits whatever
    # the shard count) and against float64 per-cell means on the host.
    x = torch.from_numpy(data).to(dev)
    valid = torch.ones(IVF_N, dtype=torch.bool, device=dev)
    init = x[:IVF_LISTS].clone()
    mesh = make_mesh(SHARD_DEVICES, devices=devs)
    new_c, assigns = sharded_kmeans_step(
        mesh, shard_rows(mesh, x), shard_rows(mesh, valid), init)
    a_1 = kmeans_assign(x, init)
    a_s = torch.cat([a.to(dev) for a in assigns])
    agree = float((a_s == a_1).float().mean())
    # The sums of the sharded step's own assignments, on one device.
    scale = fixed_point_scale(x.abs().amax(0), IVF_N)
    sums, counts = cell_sums(a_s, to_fixed(x, scale), IVF_LISTS)
    c_1 = cell_means(sums, counts, scale, init)
    bit_equal = bool(torch.equal(new_c.to(dev), c_1))
    a_np = a_s.cpu().numpy()
    n_cell = np.bincount(a_np, minlength=IVF_LISTS)
    c_64 = np.stack([np.bincount(a_np, weights=data[:, j].astype(np.float64),
                                 minlength=IVF_LISTS)
                     for j in range(IVF_DIM)], axis=1)
    c_64 = np.where(n_cell[:, None] > 0,
                    c_64 / np.maximum(n_cell, 1)[:, None],
                    init.cpu().numpy())
    c_err = float(np.abs(new_c.cpu().numpy() - c_64).max())
    emit("sharded route", path="sharded_kmeans_step", n=IVF_N,
         lists=IVF_LISTS, assignments_agree=agree,
         centroids_bit_equal_one_device=bit_equal,
         centroid_max_abs_err_f64=c_err, card=smi)
    if agree < 0.9999 or not bit_equal or c_err > 1e-6:
        raise RuntimeError("sharded_kmeans_step disagrees with one device "
                           "or with float64")
    del x, valid, init, new_c, assigns, a_1, a_s, sums, counts, c_1
    # LSH: SimpleRP-10 two-call on both sides (few codes: the host scan
    # on one device, the XOR route a shard).
    lsh_elems = elems[:ROUTE_LSH_N]
    out = []
    functor = SimpleRPFunctor(bit_length=ROUTE_LSH_BITS, random_seed=0,
                              device=str(dev))
    functor.fit(lsh_elems[:10000])
    with _env("SMQTK_TPU_NO_LSH_FUSED", "1"):
        for kw in ({"device": str(dev)},
                   {"device": devs, "n_devices": SHARD_DEVICES}):
            index = LSHNearestNeighborIndex(
                lsh_functor=functor, distance_method="euclidean", **kw)
            index.build_index(lsh_elems)
            out.append(run(index, q_elems))
    _route("lsh simple-rp-10, two calls", out[0][0], out[1][0],
           out[1][1], smi, n=ROUTE_LSH_N)
    del lsh_elems, elems, data, out, index
    torch.cuda.empty_cache()

    flat, fq = flat_data()
    f_elems = [DescriptorMemoryElement(i, flat[i]) for i in range(N_MAIN)]
    fq_elems = [DescriptorMemoryElement(("q", i), fq[i])
                for i in range(ROUTE_QUERIES)]
    for dtype in ("sq8", "pq16"):
        single, sharded = pair(FlatNearestNeighborsIndex, f_elems,
                               dtype=dtype)
        same_codec = all(
            a is None and b is None or np.array_equal(a, b)
            for a, b in zip(single._store._codec, sharded._store._codec))
        res_1, c_1 = run(single, fq_elems)
        res_s, c_s = run(sharded, fq_elems)
        if not same_codec or any(n for n in c_s.values()):
            raise RuntimeError(f"flat {dtype}: codecs differ, or the "
                               "sharded store launched a kernel")
        _route(f"flat store {dtype}", res_1, res_s, c_s, smi,
               single_launches=c_1)
        del single, sharded
    # The 2-D mesh: the flat store over ("dcn", "shard") against the 1-D
    # mesh (the same shards, merged per slice first) and one device.
    stores = []
    for mesh in (make_mesh(SHARD_DEVICES, devices=devs, dcn=2),
                 make_mesh(SHARD_DEVICES, devices=devs), None):
        store = VectorStore(mesh=mesh, device=dev)
        store.build(flat, list(range(N_MAIN)))
        stores.append(store.knn(fq[:ROUTE_QUERIES], K))
        del store
    d2, _, r2 = stores[0]
    d1, _, r1 = stores[1]
    if not (np.array_equal(r2, r1) and np.array_equal(d2, d1)):
        raise RuntimeError("the 2-D mesh differs from the 1-D mesh")
    _route("flat store float32 on a 2-D (dcn=2) mesh",
           (stores[2][2], stores[2][0]), (r2, d2), {}, smi,
           equal_to_1d_mesh=True)
    del stores
    # LinearHashIndex over 64-bit codes of the flat vectors.
    rng = np.random.default_rng(0)
    proj = rng.standard_normal((DIM, 64)).astype(np.float32)
    codes = (flat - flat.mean(0)) @ proj > 0
    out = []
    for kw in ({"device": str(dev)},
               {"device": devs, "n_devices": SHARD_DEVICES}):
        index = LinearHashIndex(**kw)
        index.build_index(codes)
        reset_counts()
        out.append(([index.nn(h, 16) for h in codes[:32]], read_counts()))
    def inside(codes, dists):
        """The codes strictly inside the k-th distance, as a set (the
        routes may order codes of one distance differently)."""
        inner = np.asarray(dists) < dists[-1]
        return {bytes(row) for row in np.packbits(np.asarray(codes)[inner],
                                                  axis=1)}
    for (c_1, d_1), (c_s, d_s) in zip(out[0][0], out[1][0]):
        if d_1 != d_s or inside(c_1, d_1) != inside(c_s, d_s):
            raise RuntimeError("sharded LinearHashIndex differs from one "
                               "device")
    emit("sharded route", path="linear hash index, 64-bit codes",
         n=N_MAIN, distances_equal=True, launches=_nonzero(out[1][1]),
         single_launches=_nonzero(out[0][1]), card=smi)
    del flat, f_elems, codes, out, index
    torch.cuda.empty_cache()
    emit("seconds", of="sharded routes", placement=placement,
         seconds=time.perf_counter() - t_all)


#: ``ivf16384-100m`` at reduced depth: the ported 100M example at this
#: many chunks of 6,291,456 rows (full width: d=128, 16,384 lists, PQ16);
#: its K7 and K8 held at the B=128 batch, nprobe 16.
IVF100M_CHUNKS = 2
IVF100M_HOLD_NPROBE = 16


def _k5_k3_100m(ctx, smi: str, dev) -> dict:
    """K5 and K3 of the 100M example's on-card oracle (``sq8_topk_blocked``
    at B=128 over the example's SQ8 tiles), held against their plain
    versions (K5 also float64) on the oracle's operands; the kernels
    line's fields of each."""
    import torch
    from smqtk_indexing_tpu_torch.ops import fused_scan, sq8
    db3, a, b, q = ctx["codes"], ctx["a"], ctx["b"], ctx["q"]
    n_tiles, d, tile_n = db3.shape
    n = n_tiles * tile_n
    sq = ctx["s2t"].reshape(n)
    pen = torch.zeros(n, device=dev)
    t = (q - b) * a
    tb = t.to(torch.bfloat16)
    nb = t.shape[0]
    n_steps, g, bw = fused_scan.step_shape(n_tiles, tile_n)
    rows = db3.transpose(1, 2).reshape(n, d)

    def f64_steps():
        """K5's m1 in float64 on its operands (the query rounded to
        bf16), step-major, and the largest sum of absolute terms."""
        tq = tb.double()
        exact = torch.empty((nb, n // 128), dtype=torch.float64, device=dev)
        mag = 0.0
        for lo in range(0, n, 1 << 18):
            u = rows[lo:lo + (1 << 18)].double()
            s = sq[lo:lo + (1 << 18)].double()
            exact[:, lo // 128:(lo + u.shape[0]) // 128] = (
                s - 2.0 * (tq @ u.T)).view(nb, -1, 128).amin(-1)
            mag = max(mag, (s.max() + 2.0 * (tq.abs() @ u.abs().T).max())
                      .item())
            del u
        return (exact.view(nb, n_steps, g).transpose(0, 1),
                torch.full((n_steps, nb, g), mag, dtype=torch.float64,
                           device=dev))
    k5 = hold("segment_minima_tiled2_ivf100m",
              lambda: fused_scan.segment_minima_tiled2(db3, sq, pen, t)[0],
              lambda: fused_scan.segment_minima_tiled2_reference(
                  db3, sq, pen, t)[0], smi, compare="f64", f64=f64_steps,
              q_axis=1, n_f64=nb, shape=[nb, n, d], steps=[n_steps, g, bw])
    k5_lib = library_mm(tb, rows.to(torch.bfloat16).T, 10)
    out_seg = nb * n // 128
    k5_bound = stage1_bound(nb, n, d, 1, out_seg + out_seg // bw)
    sid = sq8.blocked_select(db3, sq, pen, t, ctx["k"] + 16)
    k3 = hold("seg_gather_tiled_ivf100m",
              lambda: fused_scan.seg_gather_tiled(db3, sid),
              lambda: fused_scan.seg_gather_tiled_reference(db3, sid),
              smi, compare="equal",
              shape=list(sid.shape) + [d, fused_scan.SEG])
    seg_bytes = d * fused_scan.SEG
    k3_bound = bound(torch.unique(sid).numel() * seg_bytes
                     + sid.numel() * (seg_bytes + 8), 0.0, FP32_FLOPS)
    k3_lib = library_gather(db3, sid)
    del rows
    torch.cuda.empty_cache()
    return {"K5": {"max_abs_err": k5[0], "ms": k5[1], "plain_ms": k5[2],
                   **k5_bound, "library_ms": k5_lib,
                   "share": k5_bound["bound_ms"] / k5[1],
                   "shape": [nb, n, d]},
            "K3": {"max_abs_err": k3[0], "ms": k3[1], "plain_ms": k3[2],
                   **k3_bound, "library_ms": k3_lib,
                   "share": k3_bound["bound_ms"] / k3[1],
                   "shape": list(sid.shape) + [d, fused_scan.SEG]}}


def _k7_100m(ctx, smi: str) -> dict:
    """K7 of the 100M example's IVF-SQ8 sweep at B=128, nprobe 16, held
    against its plain version and float64 on the example's operands."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    db3, s2t = ctx["codes"], ctx["s2t"]
    t, ti, c0, lo, hi = ivf_scan.tiled_windows(
        ctx["a"], ctx["b"], ctx["centroids"], *ctx["layout"], ctx["q"],
        nprobe_orig=IVF100M_HOLD_NPROBE)
    args = (db3, s2t, t, ti, c0, lo, hi)
    n_tiles, d, tile = db3.shape
    cols, pairs = distinct_positions(ti.long() * tile + c0.long(), lo, hi,
                                     ivf_scan.W_TILED, n_tiles * tile)
    k7_bound = bound(cols * (d + 4) + 4 * t.numel() + 16 * ti.numel()
                     + 4 * ti.numel() * ivf_scan.W_TILED,
                     2.0 * d * pairs, FP32_FLOPS)
    live = int((hi > lo).sum())
    k7 = hold("ivf_list_scores_tiled_ivf100m",
              lambda: ivf_scan.ivf_list_scores_tiled(*args),
              lambda: ivf_scan.ivf_list_scores_tiled_reference(*args),
              smi, compare="f64", f64=lambda: _f64_tiled(*args),
              n_f64=N_ORACLE,
              shape=[ti.shape[0], ti.shape[1], ivf_scan.W_TILED],
              live_slots=live)
    return {"max_abs_err": k7[0], "ms": k7[1], "plain_ms": k7[2],
            **k7_bound, "library_ms": None,
            "share": k7_bound["bound_ms"] / k7[1], "live_slots": live,
            "slots": int(ti.numel()),
            "shape": [ti.shape[0], ti.shape[1], ivf_scan.W_TILED]}


def _k8_100m(ctx, smi: str) -> dict:
    """K8 of the 100M example's residual PQ16 sweep at B=128, nprobe 16,
    held against its plain version and float64 on the example's
    operands."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    db3c, s2t = ctx["codes"], ctx["s2t"]
    _, lut, ti, c0, lo, hi, _ = ivf_scan.tiled_windows_pq(
        ctx["codebooks"], ctx["transform"], ctx["centroids"],
        *ctx["layout"], ctx["q"], nprobe_orig=IVF100M_HOLD_NPROBE,
        residual=ctx["res_cents"] is not None)
    args = (db3c, s2t, lut, ti, c0, lo, hi)
    n_tiles, m_sub, tile = db3c.shape
    cols, pairs = distinct_positions(ti.long() * tile + c0.long(), lo, hi,
                                     ivf_scan.W_TILED, n_tiles * tile)
    k8_bound = bound(cols * (m_sub + 4) + 4 * lut.numel() + 16 * ti.numel()
                     + 4 * ti.numel() * ivf_scan.W_TILED,
                     float(m_sub) * pairs, FP32_FLOPS)
    live = int((hi > lo).sum())
    k8 = hold("ivf_list_scores_tiled_pq_ivf100m",
              lambda: ivf_scan.ivf_list_scores_tiled_pq(*args),
              lambda: ivf_scan.ivf_list_scores_tiled_pq_reference(*args),
              smi, compare="f64", f64=lambda: _f64_tiled_pq(*args),
              n_f64=N_ORACLE,
              shape=[ti.shape[0], ti.shape[1], ivf_scan.W_TILED],
              m_sub=int(m_sub), live_slots=live)
    return {"max_abs_err": k8[0], "ms": k8[1], "plain_ms": k8[2],
            **k8_bound, "library_ms": None,
            "share": k8_bound["bound_ms"] / k8[1], "live_slots": live,
            "slots": int(ti.numel()),
            "shape": [ti.shape[0], ti.shape[1], ivf_scan.W_TILED]}


def ivf_100m_phase(smi: str, dev) -> list:
    """``ivf16384-100m`` at reduced depth: the ported
    ``examples/ivf_100m.py`` at ``SMQTK_IVF100M_CHUNKS=2`` (12,582,912 x
    128 rows, 16,384 lists, SQ8 then residual PQ16) on the card, its recall
    checks raising (SQ8 against the exhaustive oracle, PQ16 against the ADC
    oracle, >= 0.99 at nprobe 2 to 16). K5 and K3 (the oracle), K7 (the
    SQ8 sweep) and K8 (the PQ16 sweep) are held against their plain
    versions on the example's operands between its phases; those holds'
    launches are taken out of the path's counts. Returns the kernels
    line's rows of the four."""
    import importlib
    import torch
    held, hold_launches = {}, {}

    def during_holds(fn):
        def hook(ctx):
            before = read_counts()
            fn(ctx)
            for name, n in read_counts().items():
                hold_launches[name] = hold_launches.get(name, 0) \
                    + n - before[name]
        return hook

    def on_sq8(ctx):
        held.update(_k5_k3_100m(ctx, smi, dev))
        held["K7"] = _k7_100m(ctx, smi)

    def on_pq(ctx):
        held["K8"] = _k8_100m(ctx, smi)

    for name in ("MINI", "NO_SQ8", "NO_PQ", "OPQ", "RAW_PQ"):
        os.environ.pop("SMQTK_IVF100M_" + name, None)
    with _env("SMQTK_IVF100M_CHUNKS", str(IVF100M_CHUNKS)):
        from smqtk_indexing_tpu_torch.examples import ivf_100m
        ivf_100m = importlib.reload(ivf_100m)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    reset_counts()
    records = ivf_100m.main(str(dev), hooks={"sq8": during_holds(on_sq8),
                                             "pq": during_holds(on_pq)})
    counts = {name: n - hold_launches.get(name, 0)
              for name, n in read_counts().items()}
    ivf_100m.check_recall(records)
    launches = {"K7": counts["ivf_list_scores_tiled"],
                "K8": counts["ivf_list_scores_tiled_pq"],
                "K5": sum(n for key, n in counts.items()
                          if key.startswith("segment_minima_tiled2:")),
                "K3": counts["seg_gather_tiled:copy"]}
    emit("main", path="ivf16384-100m example", phase_name="ivf16384-100m",
         chunks=IVF100M_CHUNKS, rows=ivf_100m.N, d=ivf_100m.D,
         n_lists=ivf_100m.C_LISTS, seconds=time.perf_counter() - t0,
         launches=_nonzero(counts), kernel_launches=launches,
         recall_checked=True, card=smi)
    if 0 in launches.values():
        raise RuntimeError(f"the 100M example skipped a kernel: {launches}")
    src = "smqtk_indexing_tpu_torch/csrc/"
    rows = []
    for name, source, replaces, key in (
            ("ivf_list_scores_tiled_ivf100m", "ivf_list_scores_tiled.cu",
             "pallas_ivf.py:469", "K7"),
            ("ivf_list_scores_tiled_pq_ivf100m",
             "ivf_list_scores_tiled_pq.cu", "pallas_ivf.py:785", "K8"),
            ("segment_minima_tiled2_ivf100m",
             "segment_minima_tiled_wgmma.cu", "pallas_scan.py:807", "K5"),
            ("seg_gather_tiled_ivf100m", "seg_gather.cu",
             "pallas_scan.py:406", "K3")):
        rows.append({"name": name, "route": "cuda", "source": src + source,
                     "replaces": "smqtk_indexing_tpu/ops/" + replaces,
                     "launches": launches[key], **held[key],
                     "timed_on": "the 100M example's operands at "
                                 f"{IVF100M_CHUNKS} chunks, B=128"})
    del ivf_100m, records
    torch.cuda.empty_cache()
    return rows


@contextlib.contextmanager
def _env(name: str, value: str):
    """``name=value`` in the environment inside the block."""
    old = os.environ.get(name)
    os.environ[name] = value
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = old


#: The instantiations of the two wgmma kernels, by their mangled names
#: (template arguments: It = uint16_t, the bf16 query; Ia = int8_t; f =
#: float, the f32 database; then kMTiles, kStreamQ and, for K1, kPasses,
#: for the tiled kernel its epilogue Variant: 0 production, 1-4 the K9
#: probe's folded, nomin, nodot, bf16min), with the SASS instruction of
#: their products: HGMMA for bf16, IGMMA for int8, None for K9's nodot,
#: which must hold no tensor-core instruction. K1: <query, database, ...>;
#: the tiled kernel: <query, ..., variant>.
WGMMA_KERNELS = {
    **{f"segment_minima_wgmma_kernel{qt}{args}{passes}":
       (f"{name} ({plan})", op)
       for qt, passes, name, op in (
           ("Itt", "Li1E", "segment_minima_bf16", "HGMMA"),
           ("Ita", "Li1E", "segment_minima_i8", "HGMMA"),
           ("Iaa", "Li1E", "segment_minima_i8i8", "IGMMA"),
           ("Itf", "Li3E", "segment_minima_f32_split3", "HGMMA"),
           ("Itf", "Li1E", "segment_minima_f32_native", "HGMMA"))
       for args, plan in (("Li2ELb0E", "256 resident"),
                          ("Li1ELb0E", "128 resident"),
                          ("Li2ELb1E", "256 streamed"))},
    **{f"tiled_minima_wgmma_kernel{qt}{args}Li{v}EE":
       (f"{name if v == 0 else f'stage1_variant_{variant}_{query}'} "
        f"({plan})", None if variant == "nodot" else op)
       for qt, name, query, op in (
           ("It", "segment_minima_tiled_i8", "bf16", "HGMMA"),
           ("Ia", "segment_minima_tiled_i8i8", "int8", "IGMMA"))
       for v, variant in enumerate(("full", "folded", "nomin", "nodot",
                                    "bf16min"))
       for args, plan in (("Li1ELb0E", "128 resident"),
                          ("Li2ELb0E", "256 resident"),
                          ("Li1ELb1E", "128 streamed"))
       # K9's other variants are built for the probe's plan only.
       if v == 0 or args == "Li1ELb0E"}}


def gmma_counts(kernels_mod) -> dict:
    """Tensor-core instructions in the SASS of each instantiation of the
    wgmma kernels (:data:`WGMMA_KERNELS`), read with the toolkit's
    ``cuobjdump`` from the built library: {name: {mnemonic: count}} for
    every ``*GMMA`` mnemonic in the function."""
    import re
    from pathlib import Path
    cuobjdump = Path(kernels_mod.nvcc()).with_name("cuobjdump")
    sass = subprocess.run(
        [str(cuobjdump), "-sass", str(kernels_mod.library_path())],
        capture_output=True, text=True, check=True, timeout=300).stdout
    counts = {name: {} for name, _ in WGMMA_KERNELS.values()}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            func = line.split("Function :", 1)[1].strip()
            name = next((n for key, (n, _) in WGMMA_KERNELS.items()
                         if key in func), None)
        elif name is not None:
            for op in re.findall(r"\b([A-Z]*GMMA)\b", line):
                counts[name][op] = counts[name].get(op, 0) + 1
    return counts


#: The IVF list scans' kernel functions (a part of each mangled name) ->
#: their names in the build line and the kernels line: K8, K7, and K6's
#: instantiations over f32 (f), bf16 bit patterns (t) and int8 (a).
IVF_KERNELS = {"ivf_list_scores_tiled_pq_kernel": "ivf_list_scores_tiled_pq",
               "ivf_list_scores_tiled_kernel": "ivf_list_scores_tiled",
               "ivf_list_scores_kernelIfE": "ivf_list_scores_f32",
               "ivf_list_scores_kernelItE": "ivf_list_scores_bf16",
               "ivf_list_scores_kernelIaE": "ivf_list_scores_i8"}


def ptxas_usage(log: str, kernel: str) -> dict:
    """Spill bytes (stores and loads) and registers of each entry function
    whose mangled name holds ``kernel``, from the build's ``ptxas -v``
    lines: {function: {"spill_bytes": n, "registers": n}}."""
    out, func = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and kernel in func and ("spill stores" in line
                                          or "registers" in line):
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            use = out.setdefault(func, {})
            if "spill stores" in line:
                use["spill_bytes"] = nums[1] + nums[2]  # stack, st, ld
            else:
                use["registers"] = nums[0]
    return out


def main() -> None:
    # The runs with the flags off must not inherit the int8 x int8 switch
    # or the f32 stage-1 mode from the caller: the store reads them per
    # query, the capacity example the first once at import. The phases
    # that want one set it themselves.
    os.environ.pop("SMQTK_TPU_SQ8_I8DOT", None)
    os.environ.pop("SMQTK_TPU_STAGE1", None)
    import torch
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    try:
        from smqtk_indexing_tpu_torch.ops import _kernels
    except ImportError as exc:
        # The script alone, without the package beside it, must fail.
        raise SystemExit(f"chip_smoke: cannot import the port ({exc}); run "
                         "it from the repository's root") from exc

    # -- 0. card -------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kind = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    emit("card", kind=kind, nvidia_smi=smi, capability=list(cap),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)
    if cap != (9, 0):
        raise RuntimeError(f"kernels are built for sm_90a; card is sm_{cap}")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. build ------------------------------------------------------
    t0 = time.perf_counter()
    info = _kernels.build()
    _kernels.library()
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln]
    gmma = gmma_counts(_kernels)
    usage = {}
    for key, (name, _) in WGMMA_KERNELS.items():
        found = ptxas_usage(info["log"], key)
        if len(found) != 1:
            raise RuntimeError(f"{name}: {len(found)} ptxas entries")
        usage[name] = next(iter(found.values()))
    # The IVF list scans (K8, K7 and K6's three forms) hold no wgmma, but
    # their registers decide how many blocks share an SM; they must not
    # spill either.
    for key, name in IVF_KERNELS.items():
        found = ptxas_usage(info["log"], key)
        if len(found) != 1:
            raise RuntimeError(f"{name}: {len(found)} ptxas entries")
        usage[name] = next(iter(found.values()))
    spills = {name: u.get("spill_bytes") for name, u in usage.items()}
    emit("build", seconds=time.perf_counter() - t0, nvcc=info["cmd"],
         ptxas=ptxas, gmma=gmma, wgmma_spill_bytes=spills,
         wgmma_registers={name: u.get("registers")
                          for name, u in usage.items()})
    for name, op in WGMMA_KERNELS.values():
        if op is None and gmma[name]:
            raise RuntimeError(f"{name} holds tensor-core instructions: "
                               f"{gmma[name]}")
        if op is not None and gmma[name].get(op, 0) == 0:
            raise RuntimeError(f"{name} holds no {op}: {gmma[name]}")
    if any(v != 0 for v in spills.values()):
        raise RuntimeError(f"a wgmma or IVF kernel spills: {spills}")
    ivf_registers = {name: usage[name]["registers"]
                     for name in IVF_KERNELS.values()}

    t0 = time.perf_counter()
    kernels = flat_phases(smi, dev)
    n_flat = len(kernels)
    emit("seconds", of="flat phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    kernels += ivf_phases(smi, dev)
    emit("seconds", of="ivf phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    k8_rows, k3_launches = ivf_pq_phases(smi, dev)
    emit("seconds", of="ivf-pq phases", seconds=time.perf_counter() - t0)
    for row in kernels:
        if row["name"] == "seg_gather_tiled":
            row["launches"] += k3_launches
    kernels += k8_rows
    t0 = time.perf_counter()
    kernels[n_flat:n_flat] = flat_codec_phases(smi, dev)
    emit("seconds", of="flat codec phases", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    kernels += probe_phase(smi, dev)
    emit("seconds", of="k10 probe phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    cap_rows, cap_k3 = capacity_phases(smi, dev)
    emit("seconds", of="capacity phases", seconds=time.perf_counter() - t0)
    for row in kernels:
        if row["name"] == "seg_gather_tiled":
            row["launches"] += cap_k3
    kernels += cap_rows
    t0 = time.perf_counter()
    kernels += lsh_phases(smi, dev)
    emit("seconds", of="hashing / lsh phase",
         seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    kernels += mrpt_phases(smi, dev)
    emit("seconds", of="mrpt phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    front_end_phase(smi, dev)
    emit("seconds", of="front-end phase", seconds=time.perf_counter() - t0)
    t0 = time.perf_counter()
    kernels += sharded_phase(smi, dev)
    emit("seconds", of="sharded-deep10m-shape phase",
         seconds=time.perf_counter() - t0)
    sharded_routes(smi, dev)
    t0 = time.perf_counter()
    kernels += ivf_100m_phase(smi, dev)
    emit("seconds", of="ivf16384-100m phase",
         seconds=time.perf_counter() - t0)
    if any(mod is not None and (name == "jax" or name.startswith("jax."))
           for name, mod in sys.modules.items()):
        raise RuntimeError("jax was imported")
    emit("seconds", of="whole script", seconds=time.perf_counter() - t_start)
    for row in kernels:
        if row["name"] in ivf_registers:
            row["registers"] = ivf_registers[row["name"]]

    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
