"""
Where the time of K7 (``csrc/ivf_list_scores_tiled.cu``) and K6
(``csrc/ivf_list_scores.cu``) goes on one CUDA card: each kernel timed
beside copies of itself with one part knocked out, as
``tools/pq_adc_split.py`` does for K8, on the IVF indexes' own operands.

- ``full``: the kernel as it is;
- ``nowork``: every slot taken as dead: no code, row or stat is read, every
  slot gets its +inf (the output's bytes alone);
- ``nolive``: the live windows without their code (K7) or row (K6) reads:
  each value is made from the loop index in a register; the stats, the
  arithmetic and every store stay;
- ``liveonly`` (K7's first design): reading only the columns of its four
  that meet the window (its thread owns four);
- ``noreduce`` (K6): the butterfly's shuffles knocked out;
- ``nostream`` (the current designs): plain 16-byte stores in place of
  streaming ones (``__stcs``); it computes ``full``'s output;
- K7's layouts tried against ``full``, which compute its output:
  ``deadlast``, ``cols16``, ``batch4``, ``rolling`` (:data:`KNOCKOUTS`).

``full - nolive`` is what the reads cost where the rest does not hide
them; ``nowork`` is the floor the output sets, beside ``fill_ms``, one
``Tensor.fill_`` of the same output (the library's rate for those bytes).
A knocked-out copy computes a wrong result; ``full`` is held against the
library's kernel (bit for bit) when it is this checkout's.

The texts to knock out differ between the kernels' designs: the first (a
block a slot, every column read) and the current one (a block a run of
slots, only the chunks of a window read). :func:`knockouts`
picks the table whose texts a source holds, so ``--against CHECKOUT``
splits an older checkout's kernels on the same operands.

    python -m smqtk_indexing_tpu_torch.tools.ivf_scan_split [--reps 20]
        [--against CHECKOUT] [--forms k7,k6_f32,k6_i8,k6_bf16]
        [--nprobe 4] [--batch 1024]

builds the serving line's index (K7's operands) and the rows tier's f32
and sq8 indexes (K6's; its bf16 form runs on the f32 rows cast to bf16)
with ``tools/ivf_times.py``, takes the windows of the first ``--batch``
held-out queries at ``--nprobe``, then builds each copy with its own
``nvcc`` into the git-ignored build directory and prints one JSON line:
the card, and for each form and checkout each copy's ptxas lines and its
ms in two rounds (forward, then backward order). It needs a card and
raises without one.
"""
from __future__ import annotations

import argparse
import ctypes
import json
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops import _kernels, ivf_scan
from smqtk_indexing_tpu_torch.tools import ivf_times
from smqtk_indexing_tpu_torch.tools.tiled_wgmma_split import build_variants

_K7_DEAD_LOOP = (
    "    for (int j = 0; j < n_pass; ++j) {\n"
    "      const int l0 = lo_s[j];\n"
    "      const int l1 = hi_s[j];\n"
    "      const bool dead = l1 <= l0 || my_chunk < l0 / kCols ||\n"
    "                        my_chunk >= (l1 + kCols - 1) / kCols;\n"
    "      if (dead) store4(pass_out + j * kWindow + 4 * tid, inf4);\n"
    "    }\n")
_PASS_END = ("    __syncthreads();  // every thread is done with this pass's "
             "tables\n")
_K7_BATCHES = (
    "  for (int64_t k0 = 0; k0 < dim; k0 += kBatch) {\n"
    "    ChunkRow nxt[kBatch];  // the next batch's rows, in flight "
    "meanwhile\n"
    "#pragma unroll\n"
    "    for (int r = 0; r < kBatch; ++r) nxt[r] = load(k0 + kBatch + r);\n"
    "#pragma unroll\n"
    "    for (int r = 0; r < kBatch; ++r) {\n"
    "      if (k0 + r < dim) fma_row(acc, t_s[k0 + r], cur[r]);\n"
    "      cur[r] = nxt[r];\n"
    "    }\n"
    "  }\n")
_K7_ROLLING = (
    "  for (int64_t k0 = 0; k0 < dim; k0 += kBatch) {\n"
    "#pragma unroll\n"
    "    for (int r = 0; r < kBatch; ++r) {\n"
    "      if (k0 + r < dim) {\n"
    "        const ChunkRow u = cur[r];\n"
    "        cur[r] = load(k0 + kBatch + r);\n"
    "        fma_row(acc, t_s[k0 + r], u);\n"
    "      }\n"
    "    }\n"
    "  }\n")
#: Kernel -> design -> variant -> ((text in the source, its
#: replacement), ...). K7's ``deadlast``, ``cols16``, ``batch4`` and
#: ``rolling`` are layouts tried against ``full`` that compute its output:
#: the dead slots' stores after the pass's scoring, 16 columns a thread
#: (16-byte loads), batches of 4 code rows, and each row's load issued
#: as the row kBatch before it is summed, in place of whole batches.
KNOCKOUTS = {
    "ivf_list_scores_tiled": {
        "runs": {
            "full": (),
            "nowork": ((
                "        n_chunks = (l1 + kCols - 1) / kCols - l0 / kCols;\n",
                ""),
                ("      if (dead) store4(pass_out + j * kWindow + 4 * tid, "
                 "inf4);\n",
                 "      store4(pass_out + j * kWindow + 4 * tid, inf4);\n")),
            "nolive": ((
                "    return k < dim ? *reinterpret_cast<const ChunkRow*>"
                "(src + k * tile_n)\n"
                "                   : ChunkRow{};\n",
                "    ChunkRow u{};\n"
                "    u.w[0] = static_cast<uint32_t>(k);\n"
                "    return u;\n"),),
            "nostream": (("  __stcs(reinterpret_cast<float4*>(p), v);\n",
                          "  *reinterpret_cast<float4*>(p) = v;\n"),),
            "deadlast": ((_K7_DEAD_LOOP, ""),
                         (_PASS_END, _K7_DEAD_LOOP + _PASS_END)),
            "cols16": (("constexpr int kCols = 8;",
                        "constexpr int kCols = 16;"),),
            "batch4": (("constexpr int kBatch = 8;",
                        "constexpr int kBatch = 4;"),),
            "rolling": ((_K7_BATCHES, _K7_ROLLING),),
        },
        "first": {
            "full": (),
            "nowork": ((
                "  if (l1 <= l0) {  // the same for every thread of the "
                "block\n", "  if (true) {\n"),),
            "nolive": ((
                "    const char4 u = __ldg(reinterpret_cast<const char4*>"
                "(src + k * tile_n));\n",
                "    const char4 u = make_char4(k, k, k, k);\n"),),
            "liveonly": ((
                "  for (int64_t k = 0; k < dim; ++k) {\n",
                "  for (int64_t k = 0; k < (col + 4 > l0 && col < l1 ? dim "
                ": 0); ++k) {\n"),),
        },
    },
    "ivf_list_scores": {
        "runs": {
            "full": (),
            "nowork": ((
                "      if (l1 > l0) n_tiles = (l1 + kTile - 1) / kTile - l0 / "
                "kTile;\n", ""),
                ("      if (dead) __stcs(pass_out + f, inf4);\n",
                 "      __stcs(pass_out + f, inf4);\n")),
            "nolive": ((
                "      piece[u] = ok[u] ? __ldg(reinterpret_cast<const "
                "uint4*>(\n"
                "                             rows + kRowGroups * u * "
                "row_bytes + 128 * cb))\n"
                "                       : make_uint4(0u, 0u, 0u, 0u);\n",
                "      piece[u] = make_uint4(u, cb, u, cb);\n"),),
            "noreduce": ((
                "      part[i] = keep + __shfl_xor_sync(0xffffffffu, send, "
                "s);\n",
                "      part[i] = keep + send;\n"),),
            "nostream": (("      if (dead) __stcs(pass_out + f, inf4);\n",
                          "      if (dead) pass_out[f] = inf4;\n"),
                         ("  __stcs(o + w, w >= l0 && w < l1 ? part[0] : ",
                          "  o[w] = (w >= l0 && w < l1 ? part[0] : ")),
        },
        "first": {
            "full": (),
            "nowork": (("  const int l1 = hi[slot];\n",
                        "  const int l1 = lo[slot];\n"),),
            "nolive": (("      load4(row + k0, v);\n",
                        "      v[0] = v[1] = v[2] = v[3] = "
                        "static_cast<float>(l);\n"),),
        },
    },
}
#: Form -> (kernel, index of tools/ivf_times.py, rows cast to bf16).
FORMS = {"k7": ("ivf_list_scores_tiled", "code_sq8", False),
         "k6_f32": ("ivf_list_scores", "rows_f32", False),
         "k6_i8": ("ivf_list_scores", "rows_sq8", False),
         "k6_bf16": ("ivf_list_scores", "rows_f32", True)}


def knockouts(kernel: str, csrc=None) -> tuple:
    """(design, its knock-out table) of ``kernel``'s source in ``csrc``
    (by default this checkout's): the table every one of whose texts the
    source holds once.

    :raises ValueError: no table fits (the kernel changed under this
        tool).
    """
    source = ivf_times.SOURCES[kernel][0]
    text = Path(csrc or _kernels.CSRC, source).read_text()
    for design, table in KNOCKOUTS[kernel].items():
        if all(text.count(old) == 1 for pairs in table.values()
               for old, _ in pairs):
            return design, table
    raise ValueError(f"{source}: no knock-out table fits its text")


def fill_ms(out: torch.Tensor, reps: int) -> float:
    """Mean ms of one ``fill_`` of ``out`` with +inf."""
    return ivf_times.kernel_ms(lambda: out.fill_(float("inf")), reps)


def split(kernel: str, args: tuple, csrc=None, reps: int = 20,
          check: bool = True) -> dict:
    """Time each knock-out copy of ``kernel``'s source in ``csrc`` on its
    operands ``args`` (``tools/ivf_times.operands``).

    :return: {"design", "full_equals_library" (when ``check``), "ms":
        {variant: [round 1, round 2]}, "ptxas": {variant: lines}}.
    """
    source = ivf_times.SOURCES[kernel][0]
    design, table = knockouts(kernel, csrc)
    built = build_variants(source, table, csrc)
    entry = ivf_times.entry_name(kernel, args)
    launches = {}
    for name, (path, _) in built.items():
        fn = getattr(ctypes.CDLL(str(path)), entry)
        fn.argtypes = _kernels._ENTRY_POINTS[entry]
        fn.restype = ctypes.c_int
        launches[name] = ivf_times.launcher(fn, kernel, args)
    result = {"design": design, "ptxas": {k: v[1] for k, v in built.items()}}
    if check:
        launch, out = launches["full"]
        launch()
        want = getattr(ivf_scan, kernel)(*args)
        result["full_equals_library"] = bool(torch.equal(out, want))
        del want
    ms = {name: [] for name in table}
    for order in (list(table), list(table)[::-1]):
        for name in order:
            ms[name].append(ivf_times.kernel_ms(launches[name][0], reps))
    result["ms"] = ms
    del launches
    torch.cuda.empty_cache()
    return result


def main(argv: Optional[list] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--against", default=None,
                    help="also split this checkout's kernels")
    ap.add_argument("--forms", default=",".join(FORMS))
    ap.add_argument("--nprobe", type=int, default=4)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ivf_scan_split needs a CUDA card")
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement

    checkouts = {"this": None}
    if args.against:
        checkouts["against"] = Path(args.against,
                                    "smqtk_indexing_tpu_torch", "csrc")
    data, queries = ivf_times.ivf_data()
    elems = [DescriptorMemoryElement(i, data[i])
             for i in range(ivf_times.N)]
    forms = args.forms.split(",")
    result = {"card": ivf_times.card_name(), "nprobe": args.nprobe,
              "batch": args.batch, "forms": {}}
    indexes = {}
    for form in forms:
        kernel, index_name, bf16 = FORMS[form]
        if index_name not in indexes:
            indexes[index_name] = ivf_times.build_index(index_name, elems)
        index = indexes[index_name]
        d_pad = index._centroids_np.shape[1]
        q_pad = torch.from_numpy(np.pad(
            queries, ((0, 0), (0, d_pad - ivf_times.DIM)))).to("cuda")
        k_args = ivf_times.operands(index, q_pad[:args.batch], args.nprobe)
        if bf16:
            k_args = (k_args[0].to(torch.bfloat16),) + k_args[1:]
        lo, hi = k_args[-2:]
        shape = tuple(lo.shape) + (
            ivf_scan.W_TILED if kernel == "ivf_list_scores_tiled"
            else ivf_scan.L_MAX,)
        entry = {"shape": list(shape), "live": int((hi > lo).sum()),
                 "fill_ms": [fill_ms(torch.empty(shape, device="cuda"),
                                     args.reps)]}
        for name, csrc in checkouts.items():
            entry[name] = split(kernel, k_args, csrc, args.reps,
                                check=name == "this")
        entry["fill_ms"].append(fill_ms(torch.empty(shape, device="cuda"),
                                        args.reps))
        del k_args
        result["forms"][form] = entry
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
