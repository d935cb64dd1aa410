"""
Build and load the port's hand-written CUDA kernels.

The sources in ``smqtk_indexing_tpu_torch/csrc/`` have a plain C interface
(no PyTorch headers), so ``nvcc`` compiles them in seconds into one shared
library, which ``ctypes`` loads:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o <build>/libsmqtk_kernels_<hash>.so
         csrc/*.cu

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
SOURCES = ("segment_minima.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: C entry points: (q, db, db_sq, penalty, out, n_queries, n_rows, dim,
#: device, stream) -> cudaError_t.
_ENTRY_POINTS = ("segment_minima_f32", "segment_minima_bf16")
_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 3
             + [ctypes.c_int, ctypes.c_void_p])

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
    for name in SOURCES:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libsmqtk_kernels_{h.hexdigest()[:16]}.so"


def build() -> dict:
    """Compile the sources into :func:`library_path` (replacing any library
    already there).

    :return: the nvcc command, its seconds and its output (ptxas register
        and spill lines).
    :raises RuntimeError: nvcc is missing or fails.
    """
    target = library_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp),
           *(str(CSRC / s) for s in SOURCES)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    # Atomic publish: a concurrent process sees the old name or the whole
    # library, never a partial file.
    os.replace(tmp, target)
    return {"cmd": cmd, "seconds": seconds,
            "log": proc.stdout + proc.stderr}


def library() -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build()
            lib = ctypes.CDLL(str(path))
            for name in _ENTRY_POINTS:
                fn = getattr(lib, name)
                fn.argtypes = _ARGTYPES
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
