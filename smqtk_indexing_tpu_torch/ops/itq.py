"""
ITQ model fitting (Gong & Lazebnik, "Iterative Quantization", CVPR 2011)
and batched sign hashing: the port of ``smqtk_indexing_tpu/ops/itq.py``.

The same algorithm as there (``:23-103``): mean-centring, PCA through
``eigh`` of the covariance, and the rotation loop (sign -> C = B^T V ->
R = polar(C^T)) with the polar factor taken by Newton-Schulz steps. Every
product is full f32 (``ops/device.require_full_f32``), as the JAX code pins
``Precision.HIGHEST``: a TF32 product on the card raises.

Trained state is not bit-equal across backends: the eigenvectors' signs
and the order of the sums differ. So the tests compare geometric
invariants of a fit, and hash with one model carried across.
"""
from __future__ import annotations

from typing import Tuple

import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32


def _polar(m: torch.Tensor, steps: int = 16) -> torch.Tensor:
    """Orthogonal polar factor by Newton-Schulz iteration,
    X <- 1.5 X - 0.5 X X^T X, from X scaled to unit Frobenius norm (which
    bounds its spectral norm below sqrt(3), where the iteration
    converges)."""
    x = m / torch.clamp(torch.linalg.matrix_norm(m), min=1e-30)
    for _ in range(steps):
        x = 1.5 * x - 0.5 * ((x @ x.T) @ x)
    return x


def itq_fit(x: torch.Tensor, r_init: torch.Tensor, *, bits: int,
            n_iter: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Fit an ITQ model on a (n, d) float32 descriptor sample.

    :param x: (n, d) descriptor matrix (already normalized if requested).
    :param r_init: (bits, bits) random Gaussian matrix, on ``x``'s device;
        orthogonalized here.
    :param bits: code length (<= d).
    :param n_iter: rotation refinement iterations (reference default 50).
    :return: (mean_vec (d,), rotation (d, bits)), f32 on ``x``'s device;
        hashing is ``(v - mean_vec) @ rotation >= 0``.
    """
    x = x.float()
    require_full_f32(x)
    n = x.shape[0]
    mean_vec = x.mean(0)
    xc = x - mean_vec[None, :]
    # PCA: the top-`bits` eigenvectors of the (symmetric) covariance.
    cov = (xc.T @ xc) / max(n - 1, 1)
    _, eigvecs = torch.linalg.eigh(cov)          # ascending eigenvalues
    pc_top = eigvecs.flip(1)[:, :bits]           # (d, bits), descending
    v = xc @ pc_top                              # (n, bits)
    r = _polar(r_init.float())
    for _ in range(n_iter):
        b = torch.where(v @ r >= 0, 1.0, -1.0)
        # argmin_R ||B - V R||_F over orthogonal R is the polar factor of
        # C^T, C = B^T V.
        r = _polar((b.T @ v).T)
    return mean_vec, pc_top @ r


def hash_batch(x: torch.Tensor, mean_vec: torch.Tensor,
               rotation: torch.Tensor) -> torch.Tensor:
    """(n, d) descriptors -> (n, bits) bool codes: one full-f32 product and
    a sign."""
    x = x.float()
    require_full_f32(x)
    return (x - mean_vec[None, :]) @ rotation >= 0
