"""
Time K8 (``ops/ivf_scan.ivf_list_scores_tiled_pq``,
``csrc/ivf_list_scores_tiled_pq.cu``) beside another checkout's K8 on one
CUDA card: alone, and inside the IVF-PQ code tier's query, at the serving
batch and at small ones.

The index is ``chip_smoke.py``'s code tier: ``IvfNearestNeighborsIndex(
n_lists=4096, dtype="opq16", storage="code", pq_residual=True,
rerank="exact")`` over 1,000,000 x 96 vectors of ``bench_all.py``'s rank-8
correlated recipe (seed 2, 1,024 held-out queries), built once with this
checkout's package. ``--against CHECKOUT`` compiles that checkout's
``csrc/ivf_list_scores_tiled_pq.cu`` alone into a library of its own (the
C entry point keeps its name and signature), so that every case runs the
same index, queries and Python with K8 from either library, in the order
against, this, this, against. For each (nprobe, B) in :data:`CASES`:

- ``k8_ms``: K8 alone on the windows of B queries
  (``ivf_scan.tiled_windows_pq``, all B in one launch), the mean over
  ``--reps`` launches between two CUDA events after a warm-up; ``equal``:
  both libraries' outputs bit for bit;
- ``query_ms``: ``nn_many`` over the same B queries, the median of
  ``--query-reps`` calls (the index cuts a batch into launches that keep
  its scores under ``ivf_scan.SCORE_BYTES``: ``launches``).

    python -m smqtk_indexing_tpu_torch.tools.k8_times [--against CHECKOUT]
        [--reps 20] [--query-reps 5]

prints one JSON line: the card, the shapes, and each library's times in
each case. It needs a card and raises without one.
"""
from __future__ import annotations

import argparse
import json
from typing import Optional

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops import _kernels, ivf_scan
from smqtk_indexing_tpu_torch.tools import ivf_times

#: chip_smoke.py's IVF-PQ code tier: vectors, dims, lists, top-k.
N, DIM, N_LISTS, K = 1_000_000, 96, 4096, 10
#: (nprobe, B): the serving batch, then 128 queries and one, at the
#: serving nprobe and at nprobe = n_lists (the exhaustive probe).
CASES = ((16, 1024), (16, 128), (16, 1), (N_LISTS, 128), (N_LISTS, 1))
ENTRY = "ivf_list_scores_tiled_pq"
SOURCE = "ivf_list_scores_tiled_pq.cu"


def pq_data(n: int = N, n_queries: int = 1024, dim: int = DIM):
    """``bench_all.py``'s correlated recipe (``bench_all.py:65-85``; rank 8,
    seed 2, scale 1.0; the port's ``bench_all._load_or_make``): a
    1,024-cluster mixture in a rank-8 latent space mixed into ``dim``
    dims; (vectors, held-out queries)."""
    from smqtk_indexing_tpu_torch.bench_all import _load_or_make
    data, queries, _ = _load_or_make("deep_base.fvecs", n, dim, 1.0, seed=2,
                                     nq=n_queries, rank=8)
    return data, queries


def _k8_ms(fn, args, reps: int):
    """K8 through the C entry point ``fn`` on the query's operands: (its
    output, mean ms over ``reps`` launches)."""
    db3c, s2t, lut, ti, c0, lo, hi = args
    _, m_sub, tile_n = db3c.shape
    b, p = ti.shape
    codes = db3c.view(torch.uint8)
    ti, c0, lo, hi = (x.to(torch.int32).contiguous()
                      for x in (ti, c0, lo, hi))
    out = torch.empty((b, p, ivf_scan.W_TILED), device=db3c.device)
    stream = torch.cuda.current_stream(db3c.device).cuda_stream

    def launch():
        _kernels.check(fn(lut.data_ptr(), codes.data_ptr(), s2t.data_ptr(),
                          ti.data_ptr(), c0.data_ptr(), lo.data_ptr(),
                          hi.data_ptr(), out.data_ptr(), b, p, m_sub,
                          tile_n, ivf_scan.W_TILED, db3c.device.index,
                          stream), ENTRY)

    return out, ivf_times.kernel_ms(launch, reps)


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", default=None,
                    help="time this checkout's K8 beside ours")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--query-reps", type=int, default=5)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("k8_times needs a CUDA card")
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    smi = ivf_times.card_name()
    libs = {"this": _kernels.library().ivf_list_scores_tiled_pq}
    if args.against:
        libs["against"] = ivf_times.build_entries(
            args.against, {ENTRY: (SOURCE, (ENTRY,))})[ENTRY]
    order = ["against", "this", "this", "against"] if args.against \
        else ["this", "this"]
    dev = torch.device("cuda")
    data, queries = pq_data()
    index = IvfNearestNeighborsIndex(
        n_lists=N_LISTS, nprobe=16, kmeans_iterations=10,
        max_points_per_centroid=64, random_seed=0, dtype="opq16",
        storage="code", pq_residual=True, rerank="exact", device="cuda")
    index.build_index([DescriptorMemoryElement(i, data[i])
                       for i in range(N)])
    q_elems = [DescriptorMemoryElement(("q", i), queries[i])
               for i in range(len(queries))]
    d_pad = index._centroids_np.shape[1]
    q_pad = torch.from_numpy(
        np.pad(queries, ((0, 0), (0, d_pad - DIM)))).to(dev)
    result = {"card": smi, "against": args.against, "reps": args.reps,
              "query_reps": args.query_reps, "m_sub":
              int(index._dev3.shape[1]), "cases": []}
    for nprobe, b in CASES:
        _, lut, ti, c0, lo, hi, _ = ivf_scan.tiled_windows_pq(
            index._cb_dev, index._perm_dev, index._dev_centroids,
            index._slot_table, index._v_tile, index._v_col, index._v_len,
            q_pad[:b], nprobe_orig=nprobe, residual=True)
        k8_args = (index._dev3, index._s2t, lut, ti, c0, lo, hi)
        index.nprobe = nprobe
        case = {"nprobe": nprobe, "batch": b, "slots": int(ti.shape[1]),
                "live": int((hi > lo).sum()),
                **{f"{w}_{name}": [] for name in libs
                   for w in ("k8_ms", "query_ms")}}
        outs = {}
        for name in order:
            outs[name], ms = _k8_ms(libs[name], k8_args, args.reps)
            case[f"k8_ms_{name}"].append(ms)
            with ivf_times.entries_from({ENTRY: libs[name]}):
                ms, case["launches"] = ivf_times.query_ms(
                    index, q_elems[:b], args.query_reps, ENTRY)
            case[f"query_ms_{name}"].append(ms)
        if args.against:
            case["equal"] = bool(torch.equal(outs["this"],
                                             outs["against"]))
        result["cases"].append(case)
        del k8_args, lut, ti, c0, lo, hi, outs
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
