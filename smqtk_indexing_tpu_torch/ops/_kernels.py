"""
Build and load the port's hand-written CUDA kernels.

The sources in ``smqtk_indexing_tpu_torch/csrc/`` have a plain C interface
(no PyTorch headers), so ``nvcc`` compiles them in seconds. Each source is
compiled to an object by its own ``nvcc``, all started together, and the
objects are linked into one shared library, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -Xptxas -v -c -o <build>/<source>.o csrc/<source>
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o <build>/libsmqtk_kernels_<hash>.so <build>/*.o

The library is built on the first call of :func:`library` (the first CUDA
launch) into ``smqtk_indexing_tpu_torch/_build/``, which git ignores, and
is named by a hash of the sources and flags, so an edited source builds
anew and an unchanged one is reused. Importing this module needs no
``nvcc``; only building does.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("segment_minima.cu", "segment_minima_wgmma.cu",
           "segment_minima_tiled.cu", "segment_minima_tiled_wgmma.cu",
           "ivf_list_scores.cu", "ivf_list_scores_tiled.cu",
           "ivf_list_scores_tiled_pq.cu", "seg_gather.cu",
           "rerank_segments.cu")
#: Headers the sources include; hashed with them.
HEADERS = ("scan_loads.cuh", "slot_runs.cuh", "tiled_minima.cuh",
           "wgmma.cuh", "wgmma_minima.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH + ("-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v")


def _args(n_ptr: int, n_int64: int, n_float: int = 0) -> list:
    """ctypes argtypes of an entry point: its pointers, its int64 sizes,
    its f32 scalars, then the device index and the stream."""
    return ([ctypes.c_void_p] * n_ptr + [ctypes.c_int64] * n_int64
            + [ctypes.c_float] * n_float + [ctypes.c_int, ctypes.c_void_p])


#: C entry points -> argtypes; each returns a cudaError_t.
_ENTRY_POINTS = {
    # (q, db, db_sq, penalty, out, n_queries, n_rows, dim): q f32 over an
    # f32 db (segment_minima.cu, FFMA: "highest"); bf16 over a bf16 db or
    # int8 codes, int8 over int8 codes (i8i8), and over an f32 db the
    # query's bf16 hi and lo (2, B, d) (f32_split3) or its hi (f32_native)
    # (the wgmma forms, segment_minima_wgmma.cu)
    "segment_minima_f32": _args(5, 3),
    "segment_minima_bf16": _args(5, 3),
    "segment_minima_i8": _args(5, 3),
    "segment_minima_i8i8": _args(5, 3),
    "segment_minima_f32_split3": _args(5, 3),
    "segment_minima_f32_native": _args(5, 3),
    # (q, db3, db_sq, penalty, out, n_queries, n_tiles, dim, tile_n): q
    # f32 over an f32 or bf16 db3 (FFMA), bf16 over int8 codes (the wgmma
    # form, segment_minima_tiled_wgmma.cu)
    "segment_minima_tiled_f32": _args(5, 4),
    "segment_minima_tiled_bf16": _args(5, 4),
    "segment_minima_tiled_i8": _args(5, 4),
    # (q, db3, db_sq, penalty, m1, m2, n_queries, n_tiles, dim, tile_n, g,
    #  bw)
    "segment_minima_tiled2_f32": _args(6, 6),
    "segment_minima_tiled2_bf16": _args(6, 6),
    "segment_minima_tiled2_i8": _args(6, 6),
    # The int8 x int8 forms (wgmma s8, segment_minima_tiled_wgmma.cu),
    # with the f32 scale of the products last:
    # (q, db3, db_sq, penalty, out, n_queries, n_tiles, dim, tile_n, scale)
    "segment_minima_tiled_i8i8": _args(5, 4, 1),
    # (q, db3, db_sq, penalty, m1, m2, n_queries, n_tiles, dim, tile_n, g,
    #  bw, scale)
    "segment_minima_tiled2_i8i8": _args(6, 6, 1),
    # (q, db3, db_sq, penalty, out, n_queries, n_tiles, dim, tile_n, g,
    #  variant)
    "stage1_variant_i8": _args(5, 6),
    "stage1_variant_i8i8": _args(5, 6),
    # (t, a, db, starts, lo, hi, out, n_queries, n_probe, dim, win)
    "ivf_list_scores_f32": _args(7, 4),
    "ivf_list_scores_bf16": _args(7, 4),
    "ivf_list_scores_i8": _args(7, 4),
    # (t, db3, s2t, ti, c0, lo, hi, out, n_queries, n_probe, dim, tile_n,
    #  win)
    "ivf_list_scores_tiled_i8": _args(8, 5),
    # (lut, db3, s2t, ti, c0, lo, hi, out, n_queries, n_probe, m_sub,
    #  tile_n, win)
    "ivf_list_scores_tiled_pq": _args(8, 5),
    # (db3, sid, out, n_seg, dim, tile_n, esize)
    "seg_gather_tiled": _args(3, 4),
    # (db, valid, q, q_norm, db_norm, seg, perm, out, pairs, s_keep, dim,
    #  metric): f32 or bf16 rows
    "rerank_segments_f32": _args(8, 4),
    "rerank_segments_bf16": _args(8, 4),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``.

    :raises RuntimeError: no ``nvcc`` found.
    """
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                           "the CUDA toolkit's nvcc on the machine with the "
                           "card.")
    return found


def library_path() -> Path:
    """The shared library's path for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsmqtk_kernels_{h.hexdigest()[:16]}.so"


def _run(cmds: list) -> str:
    """Run the commands at once; their joined output.

    :raises RuntimeError: any command fails.
    """
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    for c, p, log in zip(cmds, procs, logs):
        if p.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({p.returncode}):\n{' '.join(c)}\n{log}")
    return "".join(logs)


def build() -> dict:
    """Compile each source with its own nvcc, all at once, and link them
    into :func:`library_path` (replacing any library already there).

    :return: the nvcc commands, their seconds and their output (ptxas
        register and spill lines).
    :raises RuntimeError: nvcc is missing or fails.
    """
    target = library_path()
    tmp_dir = BUILD_DIR / f"obj.{os.getpid()}"
    tmp_dir.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    objs = [str(tmp_dir / f"{s}.o") for s in SOURCES]
    compile_cmds = [[nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(CSRC / s)]
                    for s, o in zip(SOURCES, objs)]
    link_cmd = [nvcc(), *ARCH, "-shared", "-o", str(tmp), *objs]
    t0 = time.perf_counter()
    try:
        log = _run(compile_cmds) + _run([link_cmd])
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)
    seconds = time.perf_counter() - t0
    # Atomic publish: a concurrent process sees the old name or the whole
    # library, never a partial file.
    os.replace(tmp, target)
    return {"cmd": [" ".join(c) for c in compile_cmds + [link_cmd]],
            "seconds": seconds, "log": log}


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library.

    Each entry point selects its device with ``cudaSetDevice`` and leaves
    it selected, so a caller launches inside ``torch.cuda.device`` of the
    operands' card: the guard gives the caller's current device back, and
    a later ``.to("cuda")`` does not land on the last card a shard ran
    on."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
