#!/usr/bin/env python3
"""
Smoke run of the PyTorch port (``smqtk_indexing_tpu_torch``) on one CUDA
card.

    python3 chip_smoke.py          # from the repository root

Phases, each printing one JSON line; any failure raises, so the exit code
is not 0:

0. card: the card's name and power limit from ``nvidia-smi``;
1. build: the hand-written kernels compiled with ``nvcc`` for sm_90a;
2. kernels: each kernel against its plain PyTorch version at the main
   path's shapes (B=2048 queries, N=1,048,576 rows, d=128; f32 and bf16,
   with dead rows), timed with CUDA events as plain, kernel, kernel,
   plain; plus the selection, stage-2 and whole ``flat_topk_fused``
   times at the same shapes;
3. main path: ``FlatNearestNeighborsIndex(device="cuda")`` over 1,000,000
   x 128 SIFT1M-shaped vectors (uniform * 218, seed 0, as ``bench.py``
   makes them), through ``build_index`` / ``nn_many`` with 2048 held-out
   queries at k=10, with the per-batch host-clock split of ``nn_many``
   into ``store.knn`` and result assembly (from the tracing spans);
   self-queries must return themselves and recall@10 against a float64
   oracle must be 1.0. Then smaller builds for inner_product, cosine and
   bfloat16.

Then a ``{"kernels": [...]}`` line with each kernel's launches during
phase 3, and last ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
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
#: Kernel vs plain version: the two sum exact f32 (or bf16 x bf16)
#: products in different orders, so they differ by rounding only.
REL_TOL = 1e-5


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


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import _kernels, fused_scan
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS

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
    emit("build", seconds=time.perf_counter() - t0,
         nvcc=" ".join(info["cmd"]), ptxas=ptxas)

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
    kernel_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        x = db.to(dtype)

        def plain():
            return fused_scan.segment_minima_reference(x, db_sq, penalty, q)

        def kernel():
            return fused_scan.segment_minima(x, db_sq, penalty, q)

        ref = plain()
        out = kernel()
        torch.cuda.synchronize()
        inf_match = bool(torch.equal(torch.isinf(ref), torch.isinf(out)))
        fin = torch.isfinite(ref)
        max_abs_err = (out - ref)[fin].abs().max().item()
        scale = ref[fin].abs().max().item()
        # Independent check: the first N_ORACLE queries in float64, on the
        # operands the kernel sees (bf16-rounded query for a bf16 db).
        q64 = q[:N_ORACLE].to(dtype).double()
        exact = ((db_sq.double() - 2.0 * (q64 @ x.double().T))
                 + penalty.double()).view(N_ORACLE, -1, 128).amin(-1)
        f64_err = (out[:N_ORACLE].double() - exact)[fin[:N_ORACLE]] \
            .abs().max().item()
        del q64, exact
        plain(), kernel()                                  # warm-up
        t_plain = [cuda_ms(plain, 10)]
        t_kernel = [cuda_ms(kernel, 10), cuda_ms(kernel, 10)]
        t_plain.append(cuda_ms(plain, 10))
        name = str(dtype).replace("torch.", "")
        ok = (inf_match and max_abs_err <= REL_TOL * scale
              and f64_err <= REL_TOL * scale)
        emit("kernel", kernel="segment_minima", dtype=name,
             shape=[BATCH, n_pad, DIM], max_abs_err=max_abs_err,
             f64_max_abs_err=f64_err, score_scale=scale,
             tol=REL_TOL * scale, inf_match=inf_match,
             ms=t_kernel, plain_ms=t_plain, card=smi, ok=ok)
        if not ok:
            raise RuntimeError(f"segment_minima {name} disagrees with its "
                               "plain version")
        kernel_rows[name] = (max_abs_err, statistics.mean(t_kernel),
                             statistics.mean(t_plain))
    # Stage 2 (plain PyTorch) and the segment selection at the same shapes.
    minima = fused_scan.segment_minima(db, db_sq, penalty, q)
    s_keep = fused_scan.segments_kept(K, n_pad)
    sid = fused_scan.select_segments(minima, s_keep)
    fused_scan.rerank_segments(db, valid, q, sid, k=K)     # warm-up
    select_ms = cuda_ms(lambda: fused_scan.select_segments(minima, s_keep),
                        10)
    stage2_ms = cuda_ms(lambda: fused_scan.rerank_segments(
        db, valid, q, sid, k=K), 10)
    # The whole of flat_topk_fused, as store.knn calls it: penalty,
    # stage 1, selection and stage 2.
    fused_ms = cuda_ms(lambda: fused_scan.flat_topk_fused(
        db, db_sq, valid, q, k=K), 10)
    emit("stages", shape=[BATCH, n_pad, DIM], k=K,
         stage1_ms=kernel_rows["float32"][1], select_ms=select_ms,
         stage2_ms=stage2_ms, flat_topk_fused_ms=fused_ms, card=smi)
    del db, q, dead, valid, penalty, db_sq, minima, sid, x, ref, out
    torch.cuda.empty_cache()

    # -- 3. main path through the public API ------------------------------
    rng = np.random.default_rng(0)
    data = rng.random((N_MAIN, DIM), dtype=np.float32) * 218.0
    queries = rng.random((BATCH, DIM), dtype=np.float32) * 218.0
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(N_MAIN)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(BATCH)]
    truth = oracle_topk(data, queries[:N_ORACLE], K, "euclidean")

    fused_scan.LAUNCHES = 0
    torch.cuda.reset_peak_memory_stats(dev)
    index = FlatNearestNeighborsIndex(metric="euclidean", device="cuda")
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    index.nn_many(q_elems, K)                              # warm-up
    batch_s = []
    COUNTERS.reset()
    for _ in range(5):
        t0 = time.perf_counter()
        res = index.nn_many(q_elems, K)
        batch_s.append(time.perf_counter() - t0)
    # Host-clock split of those batches, from the spans. store.knn copies
    # its results back, so its span holds the device work; the assembly
    # is host work only.
    spans = COUNTERS.snapshot()
    split_ms = {name: 1e3 * spans[f"span.{name}.seconds"]
                / spans[f"span.{name}.calls"]
                for name in ("flat.query", "store.knn", "flat.assemble")}
    found = [[e.uuid() for e in r[0]] for r in res[:N_ORACLE]]
    rec = recall(found, truth)
    self_res = index.nn_many(elems[:BATCH], K)
    self_ok = all(r[0][0].uuid() == i and r[1][0] == 0.0
                  for i, r in enumerate(self_res))
    finite = all(len(r[0]) == K and np.all(np.isfinite(r[1])) for r in res)
    emit("main", metric="euclidean", dtype="float32", n=N_MAIN, d=DIM,
         batch=BATCH, k=K, build_s=build_s, batch_s=batch_s,
         qps=BATCH / statistics.median(batch_s), split_ms=split_ms,
         recall_at_10=rec,
         self_queries_ok=self_ok, finite=finite,
         peak_device_bytes=torch.cuda.max_memory_allocated(dev), card=smi)
    if not (self_ok and finite and rec == 1.0):
        raise RuntimeError("main path: wrong results")
    del index, self_res, res

    small = data[:N_SMALL]
    small_elems = elems[:N_SMALL]
    q_small = q_elems[:B_SMALL]
    bf16_rows = torch.from_numpy(small).to(torch.bfloat16).float().numpy()
    for metric, dtype, rows in (("inner_product", "float32", small),
                                ("cosine", "float32", small),
                                ("euclidean", "bfloat16", bf16_rows)):
        index = FlatNearestNeighborsIndex(metric=metric, dtype=dtype,
                                          device="cuda")
        t0 = time.perf_counter()
        index.build_index(small_elems)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = index.nn_many(q_small, K)
        query_s = time.perf_counter() - t0
        truth = oracle_topk(rows, queries[:B_SMALL], K, metric)
        rec = recall([[e.uuid() for e in r[0]] for r in res], truth)
        emit("main", metric=metric, dtype=dtype, n=N_SMALL, d=DIM,
             batch=B_SMALL, k=K, build_s=build_s, first_batch_s=query_s,
             recall_at_10=rec, card=smi)
        if rec != 1.0:
            raise RuntimeError(f"{metric}/{dtype}: recall {rec} != 1.0")
        del index
    launches = fused_scan.LAUNCHES
    if launches == 0:
        raise RuntimeError("the main path never launched segment_minima")
    if any(mod is not None and (name == "jax" or name.startswith("jax."))
           for name, mod in sys.modules.items()):
        raise RuntimeError("jax was imported")

    err, ms, plain_ms = kernel_rows["float32"]
    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "segment_minima",
        "route": "cuda",
        "source": "smqtk_indexing_tpu_torch/csrc/segment_minima.cu",
        "replaces": "smqtk_indexing_tpu/ops/pallas_scan.py:173",
        "launches": launches,
        "max_abs_err": max(err, kernel_rows["bfloat16"][0]),
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
