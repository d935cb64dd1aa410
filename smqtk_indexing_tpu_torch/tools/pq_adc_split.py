"""
Where the time of K8, the PQ asymmetric-distance scan
(``csrc/ivf_list_scores_tiled_pq.cu``), goes on one CUDA card: the kernel
timed beside copies of itself with one part knocked out, as
``tools/tiled_wgmma_split.py`` does for K5.

- ``full``: the kernel as it is;
- ``nolookup``: each table lookup replaced by the code's bits as an f32
  (a register value: no shared-memory read; the code loads and the sums
  stay);
- ``nowork``: every slot taken as dead: no code or stat is read and no
  lookup is made, every slot gets its +inf (the output's bytes, and the
  table staging of the queries with a live slot);
- ``nostream``: the output written by plain 16-byte stores in place of
  streaming ones (``__stcs``); it computes ``full``'s output.

``full - nolookup`` is what the lookups cost where the code loads do not
hide them; ``nowork`` is the floor the output's bytes set, beside
``fill_ms``, one ``Tensor.fill_`` of the same output (the library's rate
for those bytes). A knocked-out copy computes a wrong result; only
``full`` is held against the library's kernel, bit for bit.

    python -m smqtk_indexing_tpu_torch.tools.pq_adc_split [--reps 20]
        [--live 20]

builds each copy with its own ``nvcc`` into the git-ignored build
directory, makes random operands at the serving shape (B = 1024 queries,
P = 64 slots of which ``--live`` are live windows, M = 16, 256 tiles of
4096 rows; a ``torch.Generator`` seeded with 0) and prints one JSON line:
the card, each copy's ptxas lines and its ms in two rounds (forward, then
backward order). :func:`split` times the same copies on any operands. It
needs a card and raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from typing import Optional

import torch

from smqtk_indexing_tpu_torch.ops import _kernels, ivf_scan
from smqtk_indexing_tpu_torch.tools.tiled_wgmma_split import build_variants

SOURCE = "ivf_list_scores_tiled_pq.cu"
#: Knock-outs: variant -> (text in the source, its replacement).
KNOCKOUTS = {
    "full": (),
    "nolookup": (("  return row[code];\n",
                  "  return __uint_as_float(code);\n"),),
    "nowork": (("      if (l1 <= l0) {\n", "      if (true) {\n"),),
    "nostream": (("  __stcs(reinterpret_cast<float4*>(p), v);\n",
                  "  *reinterpret_cast<float4*>(p) = v;\n"),),
}
ENTRY = "ivf_list_scores_tiled_pq"


def split(db3c, s2t, lut, ti, c0, lo, hi, reps: int = 20) -> dict:
    """Time each knock-out copy on these operands (K8's, on the card).

    :return: {"full_equals_library": bool, "ms": {variant: [round 1,
        round 2]}, "fill_ms": the output's fill_, "ptxas": {variant:
        lines}}.
    """
    built = build_variants(SOURCE, KNOCKOUTS)
    fns = {}
    for name, (path, _) in built.items():
        fn = getattr(ctypes.CDLL(str(path)), ENTRY)
        fn.argtypes = _kernels._ENTRY_POINTS[ENTRY]
        fn.restype = ctypes.c_int
        fns[name] = fn
    n_tiles, m_sub, tile_n = db3c.shape
    b, p = ti.shape
    codes = db3c.view(torch.uint8)
    ti, c0, lo, hi = (x.to(torch.int32).contiguous()
                      for x in (ti, c0, lo, hi))
    out = torch.empty((b, p, ivf_scan.W_TILED), device=db3c.device)
    stream = torch.cuda.current_stream(db3c.device).cuda_stream

    def launch(name):
        err = fns[name](lut.data_ptr(), codes.data_ptr(), s2t.data_ptr(),
                        ti.data_ptr(), c0.data_ptr(), lo.data_ptr(),
                        hi.data_ptr(), out.data_ptr(), b, p, m_sub, tile_n,
                        ivf_scan.W_TILED, db3c.device.index, stream)
        _kernels.check(err, f"{ENTRY} ({name})")

    launch("full")
    want = ivf_scan.ivf_list_scores_tiled_pq(db3c, s2t, lut, ti, c0, lo, hi)
    result = {"full_equals_library": bool(torch.equal(out, want)),
              "ptxas": {k: v[1] for k, v in built.items()}}
    del want
    ms = {name: [] for name in KNOCKOUTS}
    for order in (list(KNOCKOUTS), list(KNOCKOUTS)[::-1]):
        for name in order:
            launch(name)                                      # warm-up
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                launch(name)
            end.record()
            end.synchronize()
            ms[name].append(start.elapsed_time(end) / reps)
    result["ms"] = ms
    inf = float("inf")
    out.fill_(inf)                                            # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out.fill_(inf)
    end.record()
    end.synchronize()
    result["fill_ms"] = start.elapsed_time(end) / reps
    return result


def operands(b: int = 1024, p: int = 64, live: int = 20, m: int = 16,
             n_tiles: int = 256, seed: int = 0, device="cuda"):
    """Random K8 operands: uint8 codes and stats over ``n_tiles`` tiles of
    4096 rows, tables, and per query ``live`` whole windows at random
    tiles and 128-aligned starts, the other slots dead."""
    gen = torch.Generator(device=device).manual_seed(seed)
    tile_n, w = ivf_scan.TILE_ROWS, ivf_scan.W_TILED

    def ints(lo_, hi_, shape):
        return torch.randint(lo_, hi_, shape, generator=gen, device=device,
                             dtype=torch.int32)
    db3c = ints(0, 256, (n_tiles, m, tile_n)).to(torch.uint8)
    s2t = torch.rand((n_tiles, 1, tile_n), generator=gen, device=device)
    lut = torch.randn((b, m * 256), generator=gen, device=device)
    ti = ints(0, n_tiles, (b, p))
    c0 = ints(0, (tile_n - w) // 128 + 1, (b, p)) * 128
    lo = torch.zeros((b, p), dtype=torch.int32, device=device)
    hi = torch.zeros_like(lo)
    hi[:, :live] = w
    return db3c, s2t, lut, ti, c0, lo, hi


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--live", type=int, default=20,
                    help="live windows of the 64 slots a query")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("pq_adc_split needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    result = {"card": smi, "live": args.live,
              **split(*operands(live=args.live), reps=args.reps)}
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
