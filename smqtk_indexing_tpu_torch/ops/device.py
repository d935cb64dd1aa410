"""
Device and layout helpers for the PyTorch port.

Counterpart of ``smqtk_indexing_tpu/ops/device.py``. The pure layout
helpers (``capacity_for``, ``pow2_at_least``, ``pad_dim``, ``pad_rows_np``,
``round_up``) are the same arithmetic as there (``:19-77``), so both
packages pad and grow their stores identically. The device side is new:
an explicit ``torch.device`` everywhere, the kernel tier read from where
the tensors live, and full-f32 matrix products on the card.

``tpu_kernel_enabled`` reads the JAX package's kernel opt-outs
(``SMQTK_TPU_NO_FUSED``, ``SMQTK_TPU_NO_DMA_IVF``) per call, as there.
``stage1_precision`` reads ``SMQTK_TPU_STAGE1`` as the JAX package's does
(``ops/device.py:80-94``): the f32 flat store's stage-1 dot mode, read per
query. ``split3`` (the default) and ``native`` run on the tensor cores
(``csrc/segment_minima_wgmma.cu``: three or one bf16 passes over the hi /
lo split of both operands); ``highest`` runs exact f32 FFMA
(``csrc/segment_minima.cu``). A bf16 database or int8 codes run the
tensor cores on exact bf16 products with f32 sums whatever it says, as the
TPU kernel runs them.
"""
from __future__ import annotations

import os

import numpy as np
import torch

#: Feature dims pad to a multiple of this (the kernels stage 16-deep
#: chunks of a 128-wide depth; the JAX package's TPU lane width).
LANE = 128

# Row-capacity quantum: device row counts are always 1024 * 2^m, so any two
# capacities (and the scan chunk size) divide each other.
_CAP_BASE = 1024


def round_up(x: int, m: int) -> int:
    """Round ``x`` up to the next multiple of ``m``.

    >>> round_up(130, 128)
    256
    """
    return -(-x // m) * m


def pow2_at_least(x: int, lo: int = 1) -> int:
    """Smallest power of two >= ``x``, floored at ``lo`` (itself assumed a
    power of two): the shape-rounding primitive the stores use on batch, k
    and window dims.

    >>> pow2_at_least(5), pow2_at_least(3, lo=8)
    (8, 8)
    """
    p = lo
    while p < x:
        p *= 2
    return p


def pad_dim(d: int) -> int:
    """Pad a feature dim to a multiple of 128.

    >>> pad_dim(100), pad_dim(300)
    (128, 384)
    """
    return max(round_up(d, LANE), LANE)


def capacity_for(n: int) -> int:
    """Smallest 1024 * 2^m >= n.

    >>> capacity_for(1), capacity_for(3000)
    (1024, 4096)
    """
    cap = _CAP_BASE
    while cap < n:
        cap *= 2
    return cap


def pad_rows_np(mat: np.ndarray, rows: int, cols: int,
                dtype=np.float32) -> np.ndarray:
    """Zero-pad a host matrix to (rows, cols)."""
    n, d = mat.shape
    out = np.zeros((rows, cols), dtype=dtype)
    out[:n, :d] = mat
    return out


def resolve_device(device) -> torch.device:
    """
    :param device: ``"cuda"``, ``"cuda:<i>"``, ``"cpu"`` or a
        ``torch.device``.
    :raises RuntimeError: a CUDA device was asked for and no card is
        present. There is no fallback to the CPU.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(dev)!r}")
    return dev


def kernel_tier(device) -> str:
    """``"cuda"`` when ``device`` is a CUDA device on a machine with a card
    (the hand-written kernels run), ``"cpu-reference"`` otherwise (the
    plain PyTorch versions run)."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        return "cuda"
    return "cpu-reference"


def device_report(device, flags: tuple = ()) -> dict:
    """
    Runtime-capability report for ``usability_report()``, with the keys
    of ``smqtk_indexing_tpu.ops.device.device_report``.

    :return: dict with ``backend`` (device type), ``devices`` (card count,
        or 1 for the CPU), ``kernel_tier``, ``disabled_flags`` (those of
        ``flags`` set in the environment) and ``degraded`` (True unless the
        CUDA kernels run and no flag is set).
    """
    dev = torch.device(device)
    tier = kernel_tier(dev)
    if tier == "cuda":
        backend, n_dev = "cuda", torch.cuda.device_count()
    else:
        backend, n_dev = "cpu", 1
    disabled = [f for f in flags if os.environ.get(f)]
    return {
        "backend": backend,
        "devices": n_dev,
        "kernel_tier": tier,
        "disabled_flags": disabled,
        "degraded": tier != "cuda" or bool(disabled),
    }


def tpu_kernel_enabled(env_flag: str) -> bool:
    """Gate of an optional kernel route (``ops/device.py:148-158`` of the
    JAX package, under its name): False when ``env_flag`` is set in the
    environment, read at each call.

    It reads only the switch: the stores and indexes keep the TPU routing
    on every device, so that a CPU tensor takes the kernel's plain version
    along the same route, and only the switch sends a query to the plain
    route.
    """
    return not os.environ.get(env_flag)


#: Stage-1 dot modes for an f32 database, cheapest first
#: (``pallas_scan.PRECISIONS``).
PRECISIONS = ("native", "split3", "highest")


def stage1_precision() -> str:
    """Stage-1 dot mode for the fused flat scan (:data:`PRECISIONS`):
    'split3' by default (3-pass split-bf16, ~1e-5 relative score noise vs
    a k+8 segment margin); SMQTK_TPU_STAGE1=highest|split3|native
    overrides ('highest' = exact f32 FFMA on the CUDA cores; 'native' =
    one raw bf16 pass, only safe for bf16-stored data).

    :raises ValueError: the variable holds another value.
    """
    v = os.environ.get("SMQTK_TPU_STAGE1", "split3")
    if v not in PRECISIONS:
        # Exactness-sensitive users must not silently get the
        # approximate default off a typo.
        raise ValueError(
            f"SMQTK_TPU_STAGE1={v!r}: must be one of "
            "'native' | 'split3' | 'highest'.")
    return v


def require_full_f32(t: torch.Tensor) -> None:
    """Ranking-critical f32 products on the card must run in full f32, as
    the JAX package pins ``Precision.HIGHEST`` (``ops/scan.py:54-60``): a
    TF32 product keeps ~3 decimal digits and corrupts L2 top-k selection.
    The caller owns ``torch.backends.cuda.matmul.allow_tf32`` (False by
    default); this raises instead of changing it.

    :raises RuntimeError: ``t`` is on a card and TF32 products are on.
    """
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "torch.backends.cuda.matmul.allow_tf32 is True: this product "
            "ranks neighbours and needs full f32; set it to False.")
