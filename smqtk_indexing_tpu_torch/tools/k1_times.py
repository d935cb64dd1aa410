"""
Time K1 (``fused_scan.segment_minima``) of a checkout on one CUDA card at
the flat path's shape (B = 2048, N = 2^20, d = 128): its two forms over
int8 codes, the int8-code form (a float query, rounded to bf16) and the
int8 x int8 form (the query quantised by ``ops/sq8._i8dot_q``, as the flat
SQ8 store runs it under ``SMQTK_TPU_SQ8_I8DOT=1``), and its forms over f32
rows (uniform * 218, the flat f32 store's): ``split3``, ``native`` and
``highest`` where the checkout's ``segment_minima`` takes a ``precision``,
else its one f32 form (FFMA, before the precisions were ported). Every
checkout gets the same codes, rows and queries, made on the card from a
seed.

    python smqtk_indexing_tpu_torch/tools/k1_times.py [--root CHECKOUT]
        [--reps 20]

``--root`` imports the port from another checkout (for example an earlier
commit unpacked with ``git archive``) instead of the one that holds this
file, so that one script times both. It prints one JSON line: the card,
the package, each form's mean ms over ``--reps`` launches between two
CUDA events after a warm-up, K1's launches by form (which kernel each
number timed: ``ffma``, ``wgmma_split3``, ...), and each form's output
checksum (the int8 x int8 form is exact, so every checkout gives the same
one). It needs a card and raises without one.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path
from typing import Optional

#: The flat path's K1 shape: queries, rows, dims.
B, N, D = 2048, 1 << 20, 128


def make_operands(n: int, d: int, b: int, device, seed: int = 0):
    """SQ8-like operands: codes (n, d) int8, their stats sum((a u)^2),
    a penalty with 1% dead rows, and a float query fold t (b, d)."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    codes = torch.randint(-128, 128, (n, d), generator=g, device=device,
                          dtype=torch.int8)
    a = torch.rand(d, generator=g, device=device) * 0.02 + 0.001
    db_sq = (codes.float() * a).pow(2).sum(-1)
    penalty = torch.where(torch.rand(n, generator=g, device=device) < 0.01,
                          float("inf"), 0.0)
    t = torch.randn((b, d), generator=g, device=device) * a * 60
    return codes, db_sq, penalty, t


def make_f32_operands(n: int, d: int, b: int, device, seed: int = 1):
    """The flat f32 store's operands: rows and queries uniform * 218 (the
    SIFT1M-shaped recipe), their squared norms, 1% dead rows."""
    import torch
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand((n, d), generator=g, device=device) * 218.0
    q = torch.rand((b, d), generator=g, device=device) * 218.0
    penalty = torch.where(torch.rand(n, generator=g, device=device) < 0.01,
                          float("inf"), 0.0)
    return x, (x * x).sum(-1), penalty, q


def f32_forms(segment_minima) -> dict:
    """The f32 forms a checkout's ``segment_minima`` offers, as {name:
    keyword arguments}: each precision where it takes one, else its one
    form under the name ``f32``."""
    if "precision" in inspect.signature(segment_minima).parameters:
        return {f"f32_{p}": {"precision": p}
                for p in ("split3", "native", "highest")}
    return {"f32": {}}


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=None,
                    help="import the port from this checkout")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise RuntimeError("k1_times needs a CUDA card")
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))
    import smqtk_indexing_tpu_torch
    from smqtk_indexing_tpu_torch.ops import fused_scan, sq8

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    codes, db_sq, penalty, t = make_operands(N, D, B, "cuda")
    q_i8, sq_i8 = sq8._i8dot_q(t, db_sq)
    f32_ops = make_f32_operands(N, D, B, "cuda")
    forms = {"int8_codes": ((codes, db_sq, penalty, t), {}),
             "int8_x_int8": ((codes, sq_i8, penalty, q_i8), {}),
             **{name: (f32_ops, kw) for name, kw in
                f32_forms(fused_scan.segment_minima).items()}}
    result = {"card": smi, "package": smqtk_indexing_tpu_torch.__file__,
              "shape": [B, N, D], "reps": args.reps}
    for name, (ops, kw) in forms.items():
        out = fused_scan.segment_minima(*ops, **kw)        # warm-up
        fin = torch.isfinite(out)
        result[f"{name}_checksum"] = float(out[fin].double().sum())
        before = {k: v for k, v in fused_scan.LAUNCHES.items()}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fused_scan.segment_minima(*ops, **kw)
        end.record()
        end.synchronize()
        result[f"{name}_ms"] = start.elapsed_time(end) / args.reps
        result[f"{name}_launches"] = {
            f"{w}:{f}": n - before[w, f]
            for (w, f), n in fused_scan.LAUNCHES.items()
            if w == "segment_minima" and n != before[w, f]}
        del out, fin
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
