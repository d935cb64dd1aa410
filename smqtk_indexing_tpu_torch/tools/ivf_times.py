"""
Time K7 (``ops/ivf_scan.ivf_list_scores_tiled``,
``csrc/ivf_list_scores_tiled.cu``) and K6 (``ops/ivf_scan.ivf_list_scores``,
``csrc/ivf_list_scores.cu``) beside another checkout's on one CUDA card:
alone, and inside the IVF query, at the serving batch and at small ones.

The indexes are ``chip_smoke.py``'s: ``IvfNearestNeighborsIndex(
n_lists=4096, kmeans_iterations=10, max_points_per_centroid=64,
random_seed=0)`` over 1,000,000 x 96 vectors of ``bench.py``'s clustered
recipe (seed 2, 1,024 held-out queries), as the serving line
(``dtype="sq8", storage="code", rerank="score"``: K7) and as the rows tier
with ``dtype="float32"`` and ``"sq8"`` (K6's f32 and int8 forms), each
built once with this checkout's package. ``--against CHECKOUT`` compiles
that checkout's two sources alone into libraries of their own (the C entry
points keep their names and signatures), so that every case runs the same
indexes, queries and Python with the kernel from either library, in the
order against, this, this, against. For each index and each (nprobe, B)
in :data:`CASES`:

- ``kernel_ms``: the kernel alone on the windows of B queries (all B in
  one launch), the mean over ``--reps`` launches between two CUDA events
  after a warm-up; ``equal``: both libraries' outputs bit for bit (K7
  keeps each column's sum in the same order, so it must hold), and
  ``max_abs_diff`` between them (K6 sums in another order);
- ``query_ms``: ``nn_many`` over the same B queries, the median of
  ``--query-reps`` calls (the index cuts a batch into launches that keep
  its scores under ``ivf_scan.SCORE_BYTES``: ``launches``).

    python -m smqtk_indexing_tpu_torch.tools.ivf_times [--against CHECKOUT]
        [--reps 20] [--query-reps 5] [--indexes code_sq8,rows_f32,rows_sq8]

prints one JSON line: the card, and each index's cases with each library's
times. It needs a card and raises without one.
"""
from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops import _kernels, ivf_scan

#: chip_smoke.py's IVF indexes: vectors, dims, lists, top-k.
N, DIM, N_LISTS, K = 1_000_000, 96, 4096, 10
#: (nprobe, B): the serving batch, 128 queries at nprobe 16, one query,
#: and nprobe = n_lists (the exhaustive probe) at B 128 and 1.
CASES = ((4, 1024), (16, 128), (4, 1), (N_LISTS, 128), (N_LISTS, 1))
#: Index name -> (its constructor's arguments, the kernel it runs).
INDEXES = {
    "code_sq8": (dict(dtype="sq8", storage="code", rerank="score"),
                 "ivf_list_scores_tiled"),
    "rows_f32": (dict(dtype="float32"), "ivf_list_scores"),
    "rows_sq8": (dict(dtype="sq8"), "ivf_list_scores"),
}
#: Kernel -> (its source, its C entry points).
SOURCES = {
    "ivf_list_scores_tiled": ("ivf_list_scores_tiled.cu",
                              ("ivf_list_scores_tiled_i8",)),
    "ivf_list_scores": ("ivf_list_scores.cu",
                        ("ivf_list_scores_f32", "ivf_list_scores_bf16",
                         "ivf_list_scores_i8")),
}


def ivf_data(n: int = N, n_queries: int = 1024, dim: int = DIM):
    """``bench.py``'s serving-line recipe (``bench.py:183-190``, seed 2;
    the port's ``bench.serving_data``): a clustered Deep1M-shaped
    mixture; (vectors, held-out queries)."""
    from smqtk_indexing_tpu_torch.bench import serving_data
    return serving_data(n, dim, n_queries)


def build_index(name: str, elems, device: str = "cuda"):
    """One of :data:`INDEXES`, built over ``elems`` at nprobe 4."""
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    index = IvfNearestNeighborsIndex(
        n_lists=N_LISTS, nprobe=4, kmeans_iterations=10,
        max_points_per_centroid=64, random_seed=0, device=device,
        **INDEXES[name][0])
    index.build_index(elems)
    return index


def operands(index, q_pad: torch.Tensor, nprobe: int) -> tuple:
    """The kernel's operands for the queries ``q_pad`` (padded to the
    index's dims) at ``nprobe``, as the index's query makes them: K7's
    (db3, s2t, t, ti, c0, lo, hi) for the code tier, K6's (db, t, a,
    starts, lo, hi) for the rows tier."""
    n_lists = index._centroids_np.shape[0]
    if index._dev3 is not None:
        t, ti, c0, lo, hi = ivf_scan.tiled_windows(
            index._sq8_a, index._sq8_b, index._dev_centroids,
            index._slot_table, index._v_tile, index._v_col, index._v_len,
            q_pad, nprobe_orig=min(nprobe, n_lists))
        return index._dev3, index._s2t, t, ti, c0, lo, hi
    saved = index.nprobe
    index.nprobe = nprobe
    try:
        n_probe, nprobe_orig, first_virt = index._probe_plan()
    finally:
        index.nprobe = saved
    dq = (index._sq8_a, index._sq8_b) if index.dtype == "sq8" else None
    t, a, starts, lo, hi = ivf_scan.row_windows(
        index._dev, index._dev_centroids, index._dev_offsets,
        index._dev_lens, q_pad, n_probe=n_probe, first_virt=first_virt,
        nprobe_orig=nprobe_orig, dq=dq)
    return index._dev, t, a, starts, lo, hi


def entry_name(kernel: str, args: tuple) -> str:
    """The C entry point a kernel's wrapper calls on these operands."""
    if kernel == "ivf_list_scores_tiled":
        return "ivf_list_scores_tiled_i8"
    return {torch.float32: "ivf_list_scores_f32",
            torch.bfloat16: "ivf_list_scores_bf16",
            torch.int8: "ivf_list_scores_i8"}[args[0].dtype]


def launcher(fn, kernel: str, args: tuple):
    """(a function that launches the C entry point ``fn`` on the kernel's
    operands ``args`` and returns its output, the output)."""
    if kernel == "ivf_list_scores_tiled":
        db3, s2t, t, ti, c0, lo, hi = args
        _, d, tile_n = db3.shape
        width = ivf_scan.W_TILED
        ptrs = (t, db3, s2t, ti, c0, lo, hi)
    else:
        db, t, a, ti, lo, hi = args
        d, tile_n = db.shape[1], None
        width = ivf_scan.L_MAX
        ptrs = (t, a, db, ti, lo, hi)
    ptrs = tuple(x.to(torch.int32).contiguous()
                 if x.dtype in (torch.int32, torch.int64) else x.contiguous()
                 for x in ptrs)
    b, p = ti.shape
    out = torch.empty((b, p, width), device=args[0].device)
    sizes = (b, p, d, tile_n, width) if tile_n else (b, p, d, width)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    name = entry_name(kernel, args)

    def launch():
        _kernels.check(fn(*(x.data_ptr() for x in ptrs), out.data_ptr(),
                          *sizes, out.device.index, stream), name)
        return out
    return launch, out


def build_entries(checkout: str, sources=None) -> dict:
    """Compile ``checkout``'s sources of ``sources`` ({kernel: (source, its
    C entry points)}; by default K6's and K7's), each alone, into
    libraries of their own; {C entry point: function, typed as this
    checkout's}."""
    sources = sources or SOURCES
    csrc = Path(checkout) / "smqtk_indexing_tpu_torch" / "csrc"
    out_dir = _kernels.BUILD_DIR / "against"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {src: out_dir / f"lib{Path(src).stem}.so"
            for src, _ in sources.values()}
    _kernels._run([[_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-I", str(csrc),
                    "-shared", "-o", str(lib), str(csrc / src)]
                   for src, lib in libs.items()])
    fns = {}
    for src, entries in sources.values():
        lib = ctypes.CDLL(str(libs[src]))
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = _kernels._ENTRY_POINTS[entry]
            fn.restype = ctypes.c_int
            fns[entry] = fn
    return fns


@contextlib.contextmanager
def entries_from(fns: Optional[dict]):
    """Route ``ivf_scan``'s launches of the entry points in ``fns`` to
    those functions inside the block (``None``: this checkout's); every
    other kernel stays this checkout's."""
    if not fns:
        yield
        return
    lib = _kernels.library()

    class _Lib:
        def __getattr__(self, name):
            return fns[name] if name in fns else getattr(lib, name)

    real = _kernels.library
    _kernels.library = _Lib
    try:
        yield
    finally:
        _kernels.library = real


def kernel_ms(launch, reps: int) -> float:
    """Mean ms of ``launch`` over ``reps`` launches after a warm-up."""
    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        launch()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def query_ms(index, elems, reps: int, kernel: str):
    """Median ms of ``nn_many`` over ``elems``, and the launches a call of
    ``kernel`` (its key in ``ivf_scan.LAUNCHES``)."""
    index.nn_many(elems, K)                                   # warm-up
    before = ivf_scan.LAUNCHES[kernel]
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        index.nn_many(elems, K)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), (ivf_scan.LAUNCHES[kernel]
                                      - before) // reps


def card_name() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="time this checkout's K6 and K7 beside ours")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--query-reps", type=int, default=5)
    ap.add_argument("--indexes", default=",".join(INDEXES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ivf_times needs a CUDA card")
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement

    libs = {"this": None}
    if args.against:
        libs["against"] = build_entries(args.against)
    order = ["against", "this", "this", "against"] if args.against \
        else ["this", "this"]
    data, queries = ivf_data()
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(N)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(len(queries))]
    result = {"card": card_name(), "against": args.against,
              "reps": args.reps, "query_reps": args.query_reps,
              "indexes": {}}
    for name in args.indexes.split(","):
        kernel = INDEXES[name][1]
        t0 = time.perf_counter()
        index = build_index(name, elems)
        cases = []
        result["indexes"][name] = {"kernel": kernel, "cases": cases,
                                   "build_s": time.perf_counter() - t0}
        d_pad = index._centroids_np.shape[1]
        q_pad = torch.from_numpy(
            np.pad(queries, ((0, 0), (0, d_pad - DIM)))).to("cuda")
        for nprobe, b in CASES:
            args_k = operands(index, q_pad[:b], nprobe)
            lo, hi = args_k[-2:]
            case = {"nprobe": nprobe, "batch": b, "slots": int(lo.shape[1]),
                    "live": int((hi > lo).sum()),
                    **{f"{w}_{lib}": [] for lib in libs
                       for w in ("kernel_ms", "query_ms")}}
            outs = {}
            index.nprobe = nprobe
            for lib in order:
                with entries_from(libs[lib]):
                    fn = getattr(_kernels.library(),
                                 entry_name(kernel, args_k))
                    launch, out = launcher(fn, kernel, args_k)
                    case[f"kernel_ms_{lib}"].append(
                        kernel_ms(launch, args.reps))
                    outs[lib] = out.clone()
                    ms, case["launches"] = query_ms(
                        index, q_elems[:b], args.query_reps, kernel)
                case[f"query_ms_{lib}"].append(ms)
                del out, launch
            if args.against:
                this, other = outs["this"], outs["against"]
                case["equal"] = bool(torch.equal(this, other))
                fin = torch.isfinite(other)
                case["inf_match"] = bool(torch.equal(fin,
                                                     torch.isfinite(this)))
                diff = (this - other)[fin].abs()
                case["max_abs_diff"] = diff.max().item() if diff.numel() \
                    else 0.0
            cases.append(case)
            del args_k, outs
            torch.cuda.empty_cache()
        index.nprobe = 4
        del index
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
