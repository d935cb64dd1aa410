"""
Metric axis on the code tier, in one process: the counterpart of the
repository's ``tools/metric_ab.py``. euclidean, inner_product and cosine
over ``bench_all``'s Deep1M-shaped recipe (1,000,000 x 96, seed 2) through
the same K7 kernel (only the query fold, probe selection and finish
change), at nprobe 4 and 16: queries/s at B=1024 and recall@10 against
each metric's own float64 oracle over the original rows (codec and
probing loss together). One process, so the metrics are compared on one
card in one run.

    python -m smqtk_indexing_tpu_torch.tools.metric_ab [--device cpu]
        [--n N]

One JSON line per (metric, nprobe) with the JAX tool's keys
(``metric_axis``, ``nprobe``, ``qps_b1024``, ``recall_at_10``,
``dataset``).
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from smqtk_indexing_tpu_torch.bench_all import _elements, _load_or_make

N, D, NQ, K = 1_000_000, 96, 128, 10
NPROBES = (4, 16)
METRICS = ("euclidean", "inner_product", "cosine")


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _truth(dbf, queries, metric, db_sq):
    """Float64 top-K id sets under ``metric`` over the original rows
    (``metric_ab.py:37-58``); euclidean in the expanded form, since q^2
    does not change a query's ranking."""
    out = []
    if metric == "cosine":
        dbn = dbf / np.maximum(np.sqrt(db_sq)[:, None], 1e-30)
    for q in queries:
        qf = q.astype(np.float64)
        if metric == "euclidean":
            d = db_sq - 2.0 * (dbf @ qf)
        elif metric == "inner_product":
            d = -(dbf @ qf)
        else:
            d = -(dbn @ (qf / max(np.linalg.norm(qf), 1e-30)))
        out.append(set(np.argsort(d, kind="stable")[:K].tolist()))
    return out


def main(device: str = "cuda", n: int = N, n_lists: int = 4096,
         nq_large: int = 1024, nprobes=NPROBES) -> list:
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    db, queries, dataset = _load_or_make("deep_base.fvecs", n, D, 1.0,
                                         seed=2, nq=nq_large)
    n = db.shape[0]
    elems = _elements(db)
    nq = min(NQ, queries.shape[0])
    q_recall = _elements(queries[:nq], "q")
    q_large = _elements(queries, "Q")
    _log(f"dataset={dataset} n={n} d={D} device={device}")
    dbf = db.astype(np.float64)
    db_sq = (dbf * dbf).sum(1)
    lines = []
    for metric in METRICS:
        truth = _truth(dbf, queries[:nq], metric, db_sq)
        idx = IvfNearestNeighborsIndex(
            n_lists=n_lists, kmeans_iterations=6,
            max_points_per_centroid=64, random_seed=0, dtype="sq8",
            storage="code", rerank="score", metric=metric, device=device)
        t0 = time.perf_counter()
        idx.build_index(elems)
        _log(f"{metric}: build {time.perf_counter() - t0:.1f}s")
        for nprobe in nprobes:
            idx.nprobe = nprobe
            res = idx.nn_many(q_recall, K)            # warm
            got = [{e.uuid() for e in r} for r, _ in res]
            recall = float(np.mean([len(g & t) / K
                                    for g, t in zip(got, truth)]))
            idx.nn_many(q_large, K)                   # warm
            t0 = time.perf_counter()
            for _ in range(3):
                idx.nn_many(q_large, K)
            dt = (time.perf_counter() - t0) / 3
            line = {"metric_axis": metric, "nprobe": nprobe,
                    "qps_b1024": round(len(q_large) / dt, 0),
                    "recall_at_10": round(recall, 4), "dataset": dataset}
            print(json.dumps(line), flush=True)
            lines.append(line)
        del idx
    return lines


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    main(args.device, args.n)
