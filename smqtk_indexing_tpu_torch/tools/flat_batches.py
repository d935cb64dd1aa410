"""
Time the flat index's ``nn_many`` batches one by one, with the host's
garbage collected before each batch, so that a change in stage 1 can be
told apart from the spread of the host's result assembly.

It builds ``FlatNearestNeighborsIndex(metric="euclidean", dtype=...)``
over ``chip_smoke.py``'s SIFT1M-shaped flat data (uniform x 218, seed 0;
1,000,000 x 128 and 2048 queries unless asked for less), runs one warm-up
batch and then ``--batches`` timed batches of ``nn_many(queries, k=10)``.
For each batch it records the host-clock seconds, the tracing spans'
split (``flat.query``, ``store.knn``, ``flat.assemble``) and the garbage
collections of each generation that ran inside it.

    python smqtk_indexing_tpu_torch/tools/flat_batches.py \
        [--dtype sq8] [--batches 10] [--root CHECKOUT] [--device cuda]

``--root`` imports the port from another checkout (for example an earlier
commit unpacked with ``git archive``) instead of the one that holds this
file, so that one script times both packages. It prints one JSON line,
with K1's launches over the timed batches, and runs on the card unless
``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path
from typing import Optional

import numpy as np

SPANS = ("flat.query", "store.knn", "flat.assemble")
#: ``chip_smoke.py``'s flat width and neighbours a query.
D = 128
K = 10


def flat_data(n: int, d: int, batch: int):
    """``chip_smoke.py``'s flat data: uniform * 218 from seed 0, rows then
    queries."""
    rng = np.random.default_rng(0)
    data = rng.random((n, d), dtype=np.float32) * 218.0
    queries = rng.random((batch, d), dtype=np.float32) * 218.0
    return data, queries


def reset_k1_launches(fused_scan) -> None:
    """Set K1's launch counts in ``fused_scan`` to 0: the (wrapper, form)
    dict ``LAUNCHES`` of this package, or the int ``LAUNCHES`` and the
    ``I8DOT_LAUNCHES`` dict of a checkout from before that dict, which
    ``--root`` may import."""
    if isinstance(fused_scan.LAUNCHES, dict):
        fused_scan.LAUNCHES.update(dict.fromkeys(fused_scan.LAUNCHES, 0))
        return
    fused_scan.LAUNCHES = 0
    i8dot = getattr(fused_scan, "I8DOT_LAUNCHES", {})
    if "segment_minima" in i8dot:
        i8dot["segment_minima"] = 0


def k1_launches(fused_scan) -> int:
    """K1's launches in ``fused_scan`` over every form, in either of the
    forms of :func:`reset_k1_launches`."""
    if isinstance(fused_scan.LAUNCHES, dict):
        return sum(n for (w, _), n in fused_scan.LAUNCHES.items()
                   if w == "segment_minima")
    i8dot = getattr(fused_scan, "I8DOT_LAUNCHES", {})
    return fused_scan.LAUNCHES + i8dot.get("segment_minima", 0)


def time_batches(index, q_elems, n_batches: int) -> list:
    """A warm-up and ``n_batches`` timed ``nn_many(q_elems, K)`` batches,
    each after ``gc.collect()``: one dict a batch with its ms, the ms of
    each tracing span in it and the collections each generation ran in
    it. K1's launch count restarts from 0 after the warm-up."""
    from smqtk_indexing_tpu_torch.ops import fused_scan
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS
    index.nn_many(q_elems, K)                              # warm-up
    reset_k1_launches(fused_scan)
    out = []
    for _ in range(n_batches):
        gc.collect()
        COUNTERS.reset()
        before = [s["collections"] for s in gc.get_stats()]
        t0 = time.perf_counter()
        index.nn_many(q_elems, K)
        ms = 1e3 * (time.perf_counter() - t0)
        after = [s["collections"] for s in gc.get_stats()]
        spans = COUNTERS.snapshot()
        out.append({"ms": ms,
                    "split_ms": {name: 1e3 * spans[f"span.{name}.seconds"]
                                 for name in SPANS
                                 if spans.get(f"span.{name}.calls")},
                    "gc": [a - b for a, b in zip(after, before)]})
    return out


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", default="sq8")
    ap.add_argument("--batches", type=int, default=10)
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--root", default=None,
                    help="import the port from this checkout")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))
    import smqtk_indexing_tpu_torch
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.flat import (
        FlatNearestNeighborsIndex,
    )
    from smqtk_indexing_tpu_torch.ops import fused_scan

    data, queries = flat_data(args.n, D, args.batch)
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(args.n)]
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(args.batch)]
    index = FlatNearestNeighborsIndex(dtype=args.dtype, device=args.device)
    t0 = time.perf_counter()
    index.build_index(elems)
    build_s = time.perf_counter() - t0
    batches = time_batches(index, q_elems, args.batches)
    launches = k1_launches(fused_scan)
    result = {"package": smqtk_indexing_tpu_torch.__file__,
              "dtype": args.dtype, "n": args.n, "d": D,
              "batch": args.batch, "k": K, "build_s": build_s,
              "batch_ms": [b["ms"] for b in batches],
              "split_ms": [b["split_ms"] for b in batches],
              "gc_collections": [b["gc"] for b in batches],
              "segment_minima_launches": launches}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
