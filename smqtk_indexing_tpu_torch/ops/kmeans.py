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

``kmeans_lloyd_batched`` runs M independent Lloyd problems at once (the
PQ codebooks, one per subspace): the counterpart of the vmapped
``kmeans_lloyd`` of ``ops/pq.py:84-94``, with a batched full-f32 product
for the assignment.
"""
from __future__ import annotations

from typing import Tuple

import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32

#: Rows per streamed assignment block.
ASSIGN_CHUNK = 16384

#: Cap on the batched Lloyd's (M, rows, C) f32 score block.
BATCHED_BYTES = 1 << 28


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
    sign = _split_sign(c_count, d, x.device)
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


def _split_sign(c_count: int, d: int, device) -> torch.Tensor:
    """(C, d) +-1 pattern of the empty-cell split's perturbation."""
    return 1.0 - 2.0 * ((torch.arange(c_count, device=device)[:, None]
                         + torch.arange(d, device=device)[None, :]) % 2
                        ).float()


def kmeans_lloyd_batched(x: torch.Tensor, init: torch.Tensor, *,
                         n_iter: int) -> torch.Tensor:
    """
    M independent Lloyd problems over all-valid rows, one per leading
    index: ``kmeans_lloyd`` on each ``x[m]`` from ``init[m]``, run as one
    batched product per row block (``BATCHED_BYTES`` of scores at most),
    with the empty-cell split applied per problem.

    :param x: (M, N, d) training rows.
    :param init: (M, C, d) initial centroids.
    :return: (M, C, d) float32 centroids.
    """
    x = x.float()
    m, n, d = x.shape
    c = init.float().clone()
    c_count = c.shape[1]
    sign = _split_sign(c_count, d, x.device)
    offs = (torch.arange(m, device=x.device) * c_count)[:, None]
    chunk = max(1, BATCHED_BYTES // (4 * m * c_count))
    require_full_f32(x)
    for _ in range(n_iter):
        c_sq = (c * c).sum(-1)
        sums = torch.zeros((m * c_count, d), device=x.device)
        counts = torch.zeros(m * c_count, device=x.device)
        for lo in range(0, n, chunk):
            xb = x[:, lo:lo + chunk]
            # ||c||^2 - 2 <x, c> in one batched product; ties take the
            # lowest id, as jnp.argmin does.
            a = torch.argmin(torch.baddbmm(c_sq[:, None, :], xb,
                                           c.transpose(1, 2), alpha=-2.0),
                             dim=2)
            flat = (a + offs).reshape(-1)
            sums.index_add_(0, flat, xb.reshape(-1, d))
            counts.index_add_(0, flat, torch.ones_like(flat,
                                                       dtype=torch.float32))
        sums = sums.view(m, c_count, d)
        counts = counts.view(m, c_count)
        new_c = torch.where(counts[..., None] > 0,
                            sums / torch.clamp(counts[..., None], min=1.0), c)
        # The empty-cell split of kmeans_lloyd, per problem.
        empty = counts <= 0
        donors = torch.argsort(-counts, dim=1, stable=True)
        rank = torch.cumsum(empty.int(), dim=1) - 1
        donor_idx = torch.gather(
            donors, 1, torch.clamp(rank, 0, c_count - 1) % c_count)
        split = torch.gather(new_c, 1, donor_idx[..., None].expand(-1, -1, d)) \
            * (1.0 + 1e-4 * sign)
        c = torch.where(empty[..., None], split, new_c)
    return c


def kmeans_assign(x: torch.Tensor, centroids: torch.Tensor, *,
                  chunk: int = ASSIGN_CHUNK) -> torch.Tensor:
    """Nearest-centroid ids (N,) int64 for (N, d) rows, streamed in row
    blocks."""
    x = x.float()
    c = centroids.float()
    c_sq = (c * c).sum(-1)
    return torch.cat([_assign_block(x[lo:lo + chunk], c, c_sq)
                      for lo in range(0, max(x.shape[0], 1), chunk)])
