"""
k-means (Lloyd) training and nearest-centroid assignment, in PyTorch.

Counterpart of ``smqtk_indexing_tpu/ops/kmeans.py:51-149``. Assignment
streams row blocks of ``ASSIGN_CHUNK`` through a full-f32 matrix product
against the centroids (a plain product outside any kernel, so a library
call); the centroid update is an ``index_add_`` per block, where the JAX
package takes a ``segment_sum``. The (N, C) distance matrix never exists
whole. The empty-cell split is the JAX package's, step for step.

Sums are taken in another order than XLA's, so centroids agree with the
JAX package's to rounding, and a near tie between two centroids can
assign a row differently. Parity tests therefore load the JAX index's
trained state rather than retraining (ROADMAP queue 3, "Trained state").
"""
from __future__ import annotations

from typing import Tuple

import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32

#: Rows per streamed assignment block.
ASSIGN_CHUNK = 16384


def _assign_block(x: torch.Tensor, c: torch.Tensor,
                  c_sq: torch.Tensor) -> torch.Tensor:
    """(n, d) rows -> (n,) nearest-centroid ids under L2 (``||x||^2`` is
    constant per row and left out of the argmin). Ties take the lowest id,
    as ``jnp.argmin`` does."""
    require_full_f32(x)
    return torch.argmin(c_sq[None, :] - 2.0 * (x @ c.T), dim=1)


def kmeans_lloyd(x: torch.Tensor, valid: torch.Tensor, init: torch.Tensor,
                 *, n_iter: int, chunk: int = ASSIGN_CHUNK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Lloyd's algorithm on an (N, d) matrix; rows where ``valid`` is False
    (padding) take part in no update.

    :param x: (N, d) training rows.
    :param valid: (N,) bool mask of real rows.
    :param init: (C, d) initial centroids.
    :param n_iter: Lloyd iterations.
    :return: (centroids (C, d) float32, assignments (N,) int64 under the
        final centroids).
    """
    x = x.float()
    w = valid.float()
    n, d = x.shape
    c = init.float().clone()
    c_count = c.shape[0]
    sign = 1.0 - 2.0 * ((torch.arange(c_count, device=x.device)[:, None]
                         + torch.arange(d, device=x.device)[None, :]) % 2
                        ).float()
    for _ in range(n_iter):
        c_sq = (c * c).sum(-1)
        sums = torch.zeros_like(c)
        counts = torch.zeros(c_count, dtype=torch.float32, device=x.device)
        for lo in range(0, n, chunk):
            xb, wb = x[lo:lo + chunk], w[lo:lo + chunk]
            a = _assign_block(xb, c, c_sq)
            sums.index_add_(0, a, xb * wb[:, None])
            counts.index_add_(0, a, wb)
        new_c = torch.where(counts[:, None] > 0,
                            sums / torch.clamp(counts[:, None], min=1.0), c)
        # Empty-cell splitting (kmeans.py:101-116, the FAISS clustering
        # behaviour): the rank-r empty cell adopts a perturbed copy of the
        # rank-r largest cell's centroid, cycling. A stable sort matches
        # jnp.argsort's order among equal counts.
        empty = counts <= 0
        donors = torch.argsort(-counts, stable=True)
        rank = torch.cumsum(empty.int(), 0) - 1
        donor_idx = donors[torch.clamp(rank, 0, c_count - 1) % c_count]
        split = new_c[donor_idx] * (1.0 + 1e-4 * sign)
        c = torch.where(empty[:, None], split, new_c)
    return c, kmeans_assign(x, c, chunk=chunk)


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """Nearest-centroid ids (N,) int64 for (N, d) rows, streamed in row
    blocks."""
    x = x.float()
    c = centroids.float()
    c_sq = (c * c).sum(-1)
    return torch.cat([_assign_block(x[lo:lo + chunk], c, c_sq)
                      for lo in range(0, max(x.shape[0], 1), chunk)])
