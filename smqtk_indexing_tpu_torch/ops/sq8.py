"""
SQ8 scalar-quantized vector codec: the part the IVF index uses.

Counterpart of ``smqtk_indexing_tpu/ops/sq8.py:40-125`` (``sq8_train``,
``sq8_encode_np``, ``sq8_decode``, ``sq8_build_store``,
``sq8_row_stats``). Vectors are stored as one int8 code per dimension with
a per-dimension affine codec ``x_d ~= a_d * u_d + b_d``. The host-side
numpy functions are re-written here, not imported, because the JAX module
imports jax; they are the same arithmetic, so both packages train the same
codec and encode the same codes from the same rows.

The scan never dequantizes the database. With ``r = q - b`` and
``t = r * a``::

    ||q - x_hat||^2 = sum(r^2) - 2 <t, u> + sum(a^2 u^2)

so a kernel scores int8 codes against ``t`` plus a per-row
``s2 = sum(a^2 u^2)`` (``ops/ivf_scan.py``).

``sq8_topk`` and ``sq8_topk_blocked`` (the flat SQ8 store's scans) belong
to the codec slice and are not ported here.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch


def sq8_train(mat: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """
    Fit the per-dimension affine codec: ``a`` spans the observed range over
    the 254-step int8 grid, ``b`` centres it.

    :return: (a (d,) float32 scale, b (d,) float32 offset).
    """
    mn = mat.min(axis=0).astype(np.float64)
    mx = mat.max(axis=0).astype(np.float64)
    # Constant dimensions still decode exactly: a = 0 would divide by zero
    # in the encode, so it is floored at a tiny epsilon (codes become 0 and
    # b reproduces the constant).
    a = np.maximum((mx - mn) / 254.0, 1e-12)
    b = (mx + mn) / 2.0
    return a.astype(np.float32), b.astype(np.float32)


def sq8_encode_np(mat: np.ndarray, a: np.ndarray, b: np.ndarray
                  ) -> np.ndarray:
    """Quantize rows to int8 codes on the host (out-of-range rows clip)."""
    u = np.rint((mat.astype(np.float32) - b) / a)
    return np.clip(u, -127, 127).astype(np.int8)


def sq8_decode(codes: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """Dequantize int8 codes to float32 rows."""
    return codes.float() * a + b


def sq8_row_stats(codes: torch.Tensor, a: torch.Tensor, b: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row ``s2 = sum((a u)^2)`` and the dequantized row L2 norm."""
    u = codes.float()
    s2 = ((a * u) ** 2).sum(-1)
    x = u * a + b
    return s2, torch.sqrt((x * x).sum(-1))


def sq8_build_store(host: np.ndarray, valid_mask: np.ndarray, capacity: int,
                    d_pad: int, dim: int, device,
                    codec: Optional[Tuple[np.ndarray, np.ndarray]] = None):
    """
    The SQ8 row-major store build of the IVF rows tier: the codec trained
    over the live rows (or ``codec`` when given), padding dims with scale
    1e-12 and offset 0, so zero-padded codes and queries add nothing to any
    score term.

    :return: (a (d_pad,), b (d_pad,), codes (capacity, d_pad) int8,
        s2 (capacity,), nrm (capacity,)), tensors on ``device``.
    """
    n = host.shape[0]
    if codec is not None:
        a, b = codec
    else:
        live = host[valid_mask] if not valid_mask.all() else host
        a, b = sq8_train(live)
    a_p = np.full(d_pad, 1e-12, dtype=np.float32)
    b_p = np.zeros(d_pad, dtype=np.float32)
    a_p[:dim] = a
    b_p[:dim] = b
    codes = np.zeros((capacity, d_pad), dtype=np.int8)
    codes[:n, :dim] = sq8_encode_np(host, a, b)
    a_dev = torch.from_numpy(a_p).to(device)
    b_dev = torch.from_numpy(b_p).to(device)
    codes_dev = torch.from_numpy(codes).to(device)
    s2, nrm = sq8_row_stats(codes_dev, a_dev, b_dev)
    return a_dev, b_dev, codes_dev, s2, nrm
