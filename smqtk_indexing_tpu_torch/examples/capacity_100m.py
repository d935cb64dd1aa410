"""
The 100M-row single-copy SQ8 capacity scan on one card: the port's
counterpart of ``examples/capacity_100m.py`` and of the stages of
``tools/profile_100m.py``.

100,663,296 x 128 int8 codes (12.9 GB) live on the card in the tiled
layout, (24,576, 128, 4096), beside their 0.4 GB of row stats. The codes
are random (torch's generator, from ``seed``), and ground truth is planted
exactly as the JAX example plants it: numpy ``default_rng(0)`` queries
inside the code box and, for each of the first 128, ten codes quantized
from small perturbations of it, at rows ``PLANT_OFFSET + j *
PLANT_STRIDE``. Random codes sit at L2 distance ~13 from any query and the
planted ones at ~0.6, so the planted rows are the true top-10 by
construction: recall@10 against them must be 1.0 and the gap between the
10th and 11th neighbour wide.

    python -m smqtk_indexing_tpu_torch.examples.capacity_100m \\
        [--n-tiles 24576] [--device cuda] [--reps 3]

prints one JSON line for the build, one a batch size (128 and 256: queries/s,
recall@10 and margin) and one for the stage split. The functions are what
``chip_smoke.py`` calls. ``SMQTK_TPU_SQ8_I8DOT=1`` in the environment at
import runs stage 1 int8 x int8 (the JAX example's switch,
``examples/capacity_100m.py:60``); ``scan`` and ``stages`` also take it as
an argument.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.device import resolve_device
from smqtk_indexing_tpu_torch.ops.fused_scan import (
    TILE_N, segment_minima_tiled, segment_minima_tiled2,
)
from smqtk_indexing_tpu_torch.ops.sq8 import (
    _i8dot_q, blocked_candidates, blocked_rescore, blocked_select,
    sq8_encode_np, sq8_topk_blocked,
)

#: Tiles of 4096 rows: 100,663,296 rows, the JAX example's N.
N_TILES = 24576
D = 128
#: Queries with planted truth; the second batch size adds 128 more.
B = 128
B_BIG = 256
K = 16
K_PLANT = 10
#: Codec: codes span [-127, 127] * A_SCALE around 0.
A_SCALE = 1.0 / 64.0
SIGMA = 0.05
PLANT_OFFSET = 131
#: Tiles generated at a time: the build's f32 temporaries stay near 128 MB.
BUILD_TILES = 64
#: Stage 1 int8 x int8 (``sq8_topk_blocked(i8dot=True)``) by default.
I8DOT = os.environ.get("SMQTK_TPU_SQ8_I8DOT") == "1"


class Capacity(NamedTuple):
    """The resident index and its planted truth."""
    codes: torch.Tensor      # (n_tiles, D, TILE_N) int8
    a: torch.Tensor          # (D,) f32
    b: torch.Tensor          # (D,) f32
    s2: torch.Tensor         # (N,) f32, sum((a u)^2)
    valid: torch.Tensor      # (N,) bool
    queries: torch.Tensor    # (B_BIG, D) f32; the first B have truth
    truth: np.ndarray        # (B, K_PLANT) planted row ids


def plant(n: int):
    """The JAX example's planted set (``examples/capacity_100m.py:126-140``,
    ``:197-200``): (queries (B_BIG, D) f32, planted codes (B * K_PLANT, D)
    int8, truth (B, K_PLANT) row ids)."""
    rng = np.random.default_rng(0)
    a = np.full((D,), A_SCALE, np.float32)
    b = np.zeros((D,), np.float32)
    q = np.clip((rng.normal(size=(B, D)) * 0.5).astype(np.float32),
                -1.5, 1.5)
    planted = np.stack([
        sq8_encode_np(q[i] + rng.normal(size=(K_PLANT, D))
                      .astype(np.float32) * SIGMA, a, b)
        for i in range(B)]).reshape(B * K_PLANT, D)
    stride = n // (B * K_PLANT)
    truth = (np.arange(B * K_PLANT, dtype=np.int64) * stride
             + PLANT_OFFSET).reshape(B, K_PLANT)
    q_big = np.concatenate(
        [q, (rng.normal(size=(B_BIG - B, D)) * 0.5).astype(np.float32)])
    return q_big, planted, truth


def build(n_tiles: int = N_TILES, device="cuda", seed: int = 0) -> Capacity:
    """
    Build the tiled codes on ``device`` chunk by chunk, straight into one
    preallocated (n_tiles, D, TILE_N) int8 buffer (a relayout of the whole
    array would double it), with the planted rows written in and ``s2``
    computed a chunk at a time.

    :raises RuntimeError: ``device`` is a CUDA device and no card is
        present.
    """
    dev = resolve_device(device)
    n = n_tiles * TILE_N
    queries, planted, truth = plant(n)
    a = torch.full((D,), A_SCALE, dtype=torch.float32, device=dev)
    b = torch.zeros((D,), dtype=torch.float32, device=dev)
    codes = torch.empty((n_tiles, D, TILE_N), dtype=torch.int8, device=dev)
    s2 = torch.empty((n,), dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = torch.from_numpy(truth.reshape(-1)).to(dev)
    planted = torch.from_numpy(planted).to(dev)
    dims = torch.arange(D, device=dev)
    for t0 in range(0, n_tiles, BUILD_TILES):
        t1 = min(t0 + BUILD_TILES, n_tiles)
        chunk = codes[t0:t1]
        chunk.random_(-127, 128, generator=gen)
        hit = (rows >= t0 * TILE_N) & (rows < t1 * TILE_N)
        r = rows[hit]
        codes[(r // TILE_N)[:, None], dims, (r % TILE_N)[:, None]] = \
            planted[hit]
        s2[t0 * TILE_N:t1 * TILE_N] = \
            ((a[:, None] * chunk.float()) ** 2).sum(1).reshape(-1)
    valid = torch.ones((n,), dtype=torch.bool, device=dev)
    return Capacity(codes, a, b, s2, valid,
                    torch.from_numpy(queries).to(dev), truth)


def scan(cap: Capacity, batch: int = B, k: int = K, i8dot: bool = I8DOT):
    """``sq8_topk_blocked`` over the first ``batch`` queries: (dists (batch,
    k), rows (batch, k))."""
    return sq8_topk_blocked(cap.codes, cap.a, cap.b, cap.s2, cap.valid,
                            cap.queries[:batch], k=k, i8dot=i8dot)


def check(cap: Capacity, dists: torch.Tensor, rows: torch.Tensor) -> dict:
    """recall@10 of the planted queries against their planted rows, and
    the smallest gap between their 11th and 10th distances."""
    got = rows[:B].cpu().numpy()
    d = dists[:B].cpu().numpy()
    hits = [len(set(got[i, :K_PLANT].tolist()) & set(cap.truth[i].tolist()))
            for i in range(B)]
    return {"recall_at_10": sum(hits) / cap.truth.size,
            "planted_to_random_margin": float(np.min(
                d[:, K_PLANT] - d[:, K_PLANT - 1]))}


def _cuda_ms(fn, reps: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def stages(cap: Capacity, batch: int = B, reps: int = 3,
           i8dot: bool = I8DOT) -> dict:
    """
    Milliseconds of the scan's stages, each with the ones before it
    (``tools/profile_100m.py:86-166``), timed with CUDA events after one
    warm-up call: K2 alone, K5 alone, K5 + the step-major selection, + the
    K3 gather of the candidates, + the f32 rescore, and the whole
    ``sq8_topk_blocked``. With ``i8dot`` the stage-1 kernels take the int8
    query (its quantisation is inside "k2" and "k5").

    :raises ValueError: the index is not on a CUDA device.
    """
    if cap.codes.device.type != "cuda":
        raise ValueError("stages() times with CUDA events: the index must "
                         "be on a CUDA device")
    q = cap.queries[:batch]
    t = (q - cap.b) * cap.a
    qb = (q * cap.b).sum(-1)
    pen = torch.where(cap.valid, 0.0, math.inf).to(torch.float32)
    s_keep = K + 16

    def stage1(kernel):
        if not i8dot:
            return kernel(cap.codes, cap.s2, pen, t)
        t_i8, sq_i8 = _i8dot_q(t, cap.s2)
        return kernel(cap.codes, sq_i8, pen, t_i8)

    def select():
        return blocked_select(cap.codes, cap.s2, pen, t, s_keep, i8dot)

    def rescore():
        sid = select()
        return blocked_rescore(blocked_candidates(cap.codes, sid), sid,
                               cap.s2, cap.valid, t, qb, "euclidean", K + 8)

    fns = {
        "k2": lambda: stage1(segment_minima_tiled),
        "k5": lambda: stage1(segment_minima_tiled2),
        "k5+select": select,
        "k5+select+gather": lambda: blocked_candidates(cap.codes, select()),
        "k5+select+gather+rescore": rescore,
        "full": lambda: scan(cap, batch, i8dot=i8dot),
    }
    out = {}
    for name, fn in fns.items():
        fn()                                               # warm-up
        out[name] = _cuda_ms(fn, reps)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-tiles", type=int, default=N_TILES)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    cap = build(args.n_tiles, args.device)
    dev = cap.codes.device
    if dev.type == "cuda":
        torch.cuda.synchronize()
    print(json.dumps({"phase": "build", "rows": cap.s2.shape[0],
                      "device": torch.cuda.get_device_name(dev)
                      if dev.type == "cuda" else "cpu",
                      "seconds": time.perf_counter() - t0}), flush=True)
    for batch in (B, B_BIG):
        dists, rows = scan(cap, batch)                     # warm-up
        t0 = time.perf_counter()
        for _ in range(args.reps):
            dists, rows = scan(cap, batch)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / args.reps
        res = check(cap, dists, rows)
        print(json.dumps({"phase": "scan", "batch": batch, "k": K,
                          "i8dot": I8DOT,
                          "batch_ms": dt * 1e3, "queries_per_s": batch / dt,
                          **res}), flush=True)
    if cap.codes.is_cuda:
        print(json.dumps({"phase": "stages", "batch": B,
                          "ms": stages(cap, B, args.reps)}), flush=True)


if __name__ == "__main__":
    main()
