"""
Time the port's k-means training (``ops/kmeans.kmeans_lloyd``) of a
checkout on one CUDA card, at the two shapes the IVF builds train:

- ``ivf4096``: 262,144 x 128 rows (4,096 lists x 64 points, the IVF
  serving line's ``max_points_per_centroid`` sample), 4,096 centroids,
  10 iterations;
- ``ivf16384``: 1,048,576 x 128 rows, 16,384 centroids, 8 iterations
  (the 100M example's coarse quantizer).

Rows are clustered normal draws made on the card from a seed; the init is
the first C rows, as the example takes it. Beside each training it times
the assignment alone (``kmeans_assign`` over the rows, once an
iteration): the part of a Lloyd iteration that is not the centroid
update.

    python -m smqtk_indexing_tpu_torch.tools.kmeans_times [--reps 3]

It times the package that Python imports: to time another checkout,
run this file by its path with ``PYTHONPATH`` set to that checkout. It
prints one JSON line: the card, the package, and per shape the mean
seconds of ``kmeans_lloyd`` over ``--reps`` runs after a warm-up, the
assignment passes' seconds, and whether two runs gave bit-equal
centroids. It needs a card and raises without one.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from pathlib import Path

#: (name, rows, centroids, iterations, dims).
SHAPES = (("ivf4096", 1 << 18, 4096, 10, 128),
          ("ivf16384", 1 << 20, 16384, 8, 128))


def make_rows(n: int, c: int, d: int, device, seed: int = 0):
    """(n, d) f32 rows around ``c`` normal centres, made on ``device``."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    centres = torch.randn((c, d), generator=g, device=device)
    pick = torch.randint(0, c, (n,), generator=g, device=device)
    return centres[pick] + 0.25 * torch.randn((n, d), generator=g,
                                              device=device)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()
    import torch
    from smqtk_indexing_tpu_torch.ops import kmeans
    if not torch.cuda.is_available():
        raise SystemExit("kmeans_times: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    out = {"card": smi, "package": str(Path(kmeans.__file__).parents[2])}
    for name, n, c, iters, d in SHAPES:
        x = make_rows(n, c, d, dev)
        valid = torch.ones(n, dtype=torch.bool, device=dev)
        init = x[:c].clone()

        def train():
            return kmeans.kmeans_lloyd(x, valid, init, n_iter=iters)[0]
        first = train()                                   # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(args.reps):
            again = train()
        torch.cuda.synchronize()
        train_s = (time.perf_counter() - t0) / args.reps
        t0 = time.perf_counter()
        for _ in range(iters):
            kmeans.kmeans_assign(x, first)
        torch.cuda.synchronize()
        out[name] = {"rows": n, "centroids": c, "iterations": iters,
                     "train_s": train_s,
                     "assign_passes_s": time.perf_counter() - t0,
                     "centroids_bit_equal": bool(torch.equal(first, again))}
        del x, valid, init, first, again
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
