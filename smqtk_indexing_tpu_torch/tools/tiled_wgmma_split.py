"""
Where the time of the capacity scan's stage 1 on the tensor cores goes, on
one CUDA card: K5's ``wgmma`` kernel (``csrc/segment_minima_tiled_wgmma.cu``)
timed beside copies of itself with one part knocked out, in either form:
``--form bf16`` (the float query rounded to bf16, the flag off; default)
or ``--form s8`` (the ``i8dot`` int8 query, ``wgmma`` s8).

- ``full``: the kernel as it is;
- ``nofold``: the epilogue's fold (db_sq, penalty and the minimum over the
  thread's 32 columns) replaced by a copy of two accumulators;
- ``nostage``: no code is loaded or staged after the prologue (the
  products read whatever the ring holds);
- ``noproducts``: no ``wgmma`` is issued (the fences, commits and waits
  stay).

Each difference from ``full`` is what that part costs where it is not
hidden under the others. A knocked-out copy computes a wrong result; only
``full`` is held against the library's kernel, bit for bit.

    python -m smqtk_indexing_tpu_torch.tools.tiled_wgmma_split [--reps 5]
        [--form bf16|s8]

builds each copy with its own ``nvcc`` into the git-ignored build
directory, builds the capacity index on the card
(``examples/capacity_100m.build``, 12.9 GB), and prints one JSON line: the
card, each copy's ptxas register and spill lines, and its K5 ms at B=128
and 256 in two rounds (forward, then backward order). It needs a card and
raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path
from typing import Optional

import torch

from smqtk_indexing_tpu_torch.ops import _kernels, fused_scan

SOURCE = "segment_minima_tiled_wgmma.cu"
#: Knock-outs: variant -> (text in the source, its replacement).
KNOCKOUTS = {
    "full": (),
    "nofold": ((
        "      fold_minima<kMTiles, V != kFolded, V == kBf16Min>(\n"
        "          acc, scale, [&](int jj) {\n"
        "            const float2 a = *reinterpret_cast<const float2*>(sq + 8 * jj);\n"
        "            const float2 b = V == kFolded\n"
        "                ? make_float2(0.0f, 0.0f)\n"
        "                : *reinterpret_cast<const float2*>(sq + kSeg + 8 * jj);\n"
        "            return make_float4(a.x, a.y, b.x, b.y);\n"
        "          }, m);\n",
        "#pragma unroll\n"
        "      for (int i = 0; i < kMTiles; ++i) {\n"
        "        m[i][0] = acc[i][0];\n"
        "        m[i][1] = acc[i][1];\n"
        "      }\n"),),
    "nostage": ((
        "      store_codes(t + 1);\n"
        "      if (t + 2 < n_steps) load_codes();\n", ""),),
    "noproducts": ((
        "          wgmma_step(acc[i], a_desc, b_desc, (c | k) != 0);\n",
        ""),),
}
BATCHES = (128, 256)
#: K5's entry point of each form.
ENTRIES = {"bf16": "segment_minima_tiled2_i8",
           "s8": "segment_minima_tiled2_i8i8"}


def variant_source(name: str, source: str = SOURCE,
                   knockouts: dict = KNOCKOUTS, csrc=None) -> str:
    """The kernel's source (in ``csrc``, by default this checkout's
    ``csrc/``) with ``name``'s knock-outs applied.

    :raises ValueError: a knock-out's text is not in the source (the
        kernel changed under this tool).
    """
    text = Path(csrc or _kernels.CSRC, source).read_text()
    for old, new in knockouts[name]:
        if text.count(old) != 1:
            raise ValueError(f"{name}: the text to knock out is not in "
                             f"{source} once")
        text = text.replace(old, new)
    return text


def build_variants(source: str = SOURCE, knockouts: dict = KNOCKOUTS,
                   csrc=None) -> dict:
    """Compile every variant of ``source`` (in ``csrc``, by default this
    checkout's ``csrc/``, whose headers it includes) into its own library,
    all at once (also ``tools/pq_adc_split.py``'s, for K8, and
    ``tools/ivf_scan_split.py``'s, for K6 and K7).

    :return: variant -> (library path, ptxas register and spill lines).
    """
    csrc = Path(csrc or _kernels.CSRC)
    digest = hashlib.sha256()
    for name in (source,) + _kernels.HEADERS:
        if (csrc / name).exists():
            digest.update((csrc / name).read_bytes())
    out_dir = _kernels.BUILD_DIR / f"split_{digest.hexdigest()[:16]}"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in knockouts:
        src = out_dir / f"{name}.cu"
        src.write_text(variant_source(name, source, knockouts, csrc))
        lib = out_dir / f"lib{name}.so"
        procs[name] = (lib, subprocess.Popen(
            [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-I",
             str(csrc), "-shared", "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        built[name] = (lib, [ln.strip() for ln in log.splitlines()
                             if "registers" in ln or "spill" in ln
                             or "entry function" in ln])
    return built


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--n-tiles", type=int, default=None)
    ap.add_argument("--form", choices=sorted(ENTRIES), default="bf16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tiled_wgmma_split needs a CUDA card")
    from smqtk_indexing_tpu_torch.examples import capacity_100m as capm
    from smqtk_indexing_tpu_torch.ops.sq8 import _i8dot_q

    entry = ENTRIES[args.form]
    libs = {}
    built = build_variants()
    for name, (path, _) in built.items():
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = _kernels._ENTRY_POINTS[entry]
        fn.restype = ctypes.c_int
        libs[name] = fn
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    cap = capm.build(args.n_tiles or capm.N_TILES, "cuda", seed=0)
    n_tiles, d, tile_n = cap.codes.shape
    pen = torch.zeros(n_tiles * tile_n, device="cuda")
    _, g, bw = fused_scan.step_shape(n_tiles, tile_n)
    nseg = n_tiles * tile_n // fused_scan.SEG
    stream = torch.cuda.current_stream().cuda_stream
    result = {"card": smi, "form": args.form, "rows": n_tiles * tile_n,
              "d": d, "g": g, "bw": bw,
              "ptxas": {k: v[1] for k, v in built.items()}}
    for b in BATCHES:
        t = (cap.queries[:b] - cap.b) * cap.a
        if args.form == "s8":
            q, sq = _i8dot_q(t, cap.s2)
            scale = (1.0,)
        else:
            q, sq, scale = t.to(torch.bfloat16), cap.s2, ()
        m1 = torch.empty((nseg // g, b, g), device="cuda")
        m2 = torch.empty((nseg // g, b, g // bw), device="cuda")

        def launch(name):
            err = libs[name](q.data_ptr(), cap.codes.data_ptr(),
                             sq.data_ptr(), pen.data_ptr(),
                             m1.data_ptr(), m2.data_ptr(), b, n_tiles, d,
                             tile_n, g, bw, *scale, 0, stream)
            _kernels.check(err, f"{entry} ({name})")
        launch("full")
        got = m1.clone(), m2.clone()
        want = fused_scan.segment_minima_tiled2(
            cap.codes, sq, pen, q if args.form == "s8" else q.float())
        result[f"full_equals_library_b{b}"] = bool(
            torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]))
        del got, want
        ms = {name: [] for name in KNOCKOUTS}
        for order in (list(KNOCKOUTS), list(KNOCKOUTS)[::-1]):
            for name in order:
                launch(name)                                  # warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    launch(name)
                end.record()
                end.synchronize()
                ms[name].append(start.elapsed_time(end) / args.reps)
        result[f"k5_ms_b{b}"] = ms
        del m1, m2, q, sq
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
