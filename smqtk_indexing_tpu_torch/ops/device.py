"""
Device and layout helpers for the PyTorch port.

Counterpart of ``smqtk_indexing_tpu/ops/device.py``. The pure layout
helpers (``capacity_for``, ``pow2_at_least``, ``pad_dim``, ``pad_rows_np``,
``round_up``) import jax nowhere and are re-exported from there, so both
packages pad and grow their stores identically. The device side is new:
an explicit ``torch.device`` everywhere, the kernel tier read from where
the tensors live, and full-f32 matrix products on the card.

``stage1_precision`` / ``SMQTK_TPU_STAGE1`` (``ops/device.py:80-94``) is not
ported: the port's stage 1 is exact f32 FFMA (``csrc/segment_minima.cu``),
so there is no reduced-precision mode to choose.
"""
from __future__ import annotations

import os

import torch

from smqtk_indexing_tpu.ops.device import (  # noqa: F401  (re-exported)
    capacity_for, pad_dim, pad_rows_np, pow2_at_least, round_up,
)


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
