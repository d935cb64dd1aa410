"""
Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense rates,
no sparsity, at the full 700 W power limit) and the roofline bounds the
per-layer metrics divide by. A share is stated against these peaks, with
the card's power limit beside it (:func:`power_limit_w`).
"""
from __future__ import annotations

import shutil
import subprocess
from typing import Optional, Tuple

#: HBM3 bandwidth, bytes/s.
HBM_BYTES_S = 3.35e12
#: Dense bf16 / fp16 tensor-core rate, FLOP/s.
BF16_FLOP_S = 989e12
#: TF32 tensor-core rate, FLOP/s.
TF32_FLOP_S = 495e12
#: float32 outside the tensor cores, FLOP/s.
FP32_FLOP_S = 67e12
#: Dense int8 tensor-core rate, OP/s.
INT8_OP_S = 1979e12


def bound_s(flops: float, nbytes: float,
            flop_s: float = BF16_FLOP_S) -> Tuple[float, str]:
    """The least time the card could take: the larger of ``flops`` over
    ``flop_s`` and ``nbytes`` over the HBM bandwidth, and which one it is
    (``"flops"`` or ``"bytes"``)."""
    t_f, t_b = flops / flop_s, nbytes / HBM_BYTES_S
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")


def flat_stage1(b: int, n_live: int, d: int) -> Tuple[float, str]:
    """Bound of an exact flat scan's stage 1 (the segment minima of ``b``
    queries over ``n_live`` f32 rows of width ``d``, and their selection).

    Counts the work the inputs need, whatever implements it: the live rows
    read once, the queries once, the (b, n_live / 128) f32 minima written
    once; 2 b n_live d operations at the dense bf16 tensor rate. Padded
    capacity is not work, so it shows as a lower share.
    """
    nbytes = 4.0 * (n_live * d + b * d + b * n_live / 128.0)
    return bound_s(2.0 * b * n_live * d, nbytes)


def power_limit_w(index: int = 0) -> Optional[float]:
    """The card's power limit in W from ``nvidia-smi``, or None where it
    cannot be read."""
    exe = shutil.which("nvidia-smi")
    if exe is None:
        return None
    try:
        out = subprocess.run(
            [exe, f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=30, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
