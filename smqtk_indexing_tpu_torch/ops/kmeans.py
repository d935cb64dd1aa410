"""
k-means (Lloyd) training and nearest-centroid assignment, in PyTorch.

Counterpart of ``smqtk_indexing_tpu/ops/kmeans.py:51-149``. Assignment
streams row blocks of ``ASSIGN_CHUNK`` through a full-f32 matrix product
against the centroids (a plain product outside any kernel, so a library
call). The (N, C) distance matrix never exists whole. The empty-cell split
is the JAX package's, step for step.

The centroid update (the JAX package's ``segment_sum``) is
:func:`cell_sums`: each row becomes int64 fixed point under a power-of-two
scale per column (:func:`fixed_point_scale`, chosen so that no sum over
the training set can overflow), a block's rows are sorted by cell and
each cell's sum is a difference of an int64 prefix sum. Integer sums are
exact, so they do not depend on the order of the additions: two runs from
one seed train the same centroids bit for bit on a card (an ``index_add_``
adds floats by atomics in no fixed order there), the CPU runs the same
arithmetic, and shards' partial sums add exactly. A value is rounded to
``2^-(62 - ceil(log2 N))`` of its column's largest magnitude, far below
the f32 step of a sum.

Sums are exact where XLA's are rounded, so centroids agree with the JAX
package's to rounding, and a near tie between two centroids can assign a
row differently. Parity tests therefore load the JAX index's trained
state rather than retraining (ROADMAP queue 3, "Trained state").

``kmeans_lloyd_batched`` runs M independent Lloyd problems at once (the
PQ codebooks, one per subspace): the counterpart of the vmapped
``kmeans_lloyd`` of ``ops/pq.py:84-94``, with a batched full-f32 product
for the assignment.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32

#: Rows per streamed assignment block.
ASSIGN_CHUNK = 16384

#: Cap on the batched Lloyd's (M, rows, C) f32 score block.
BATCHED_BYTES = 1 << 28


def fixed_point_scale(amax: torch.Tensor, n_rows: int) -> torch.Tensor:
    """
    Per-column powers of two that map rows to int64 fixed point: with
    ``|x| <= amax`` in a column, ``round(x * scale)`` stays within
    ``2^(62 - bits(n_rows))``, so a sum of ``n_rows`` of them, and every
    prefix of it, fits an int64. Worked out on the host, so the scale is
    exact.

    :param amax: (..., d) largest magnitude of each column.
    :param n_rows: rows any one sum, or prefix sum, may take.
    :return: float64 tensor of ``amax``'s shape, on its device.
    """
    head = max(int(n_rows), 1).bit_length()
    exps = [62 - head - math.frexp(float(v))[1]
            for v in amax.detach().double().cpu().reshape(-1).tolist()]
    scale = torch.tensor([math.ldexp(1.0, e) for e in exps],
                         dtype=torch.float64)
    return scale.reshape(amax.shape).to(amax.device)


def to_fixed(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 rows as int64 fixed point under ``scale`` (exact but for the
    rounding to the grid, half to even)."""
    return torch.round(x.double() * scale).long()


def cell_sums(keys: torch.Tensor, rows: torch.Tensor, n_cells: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Per-cell sums of int64 rows and per-cell row counts, in a fixed order:
    a stable sort of the rows by cell, one int64 prefix sum, differenced
    at the cells' bounds. Rows with key ``n_cells`` (padding) fall past the
    last bound and count nowhere. Leading dims are independent problems,
    each with its own sort and its own prefix sum, so a prefix spans one
    problem's rows only: the bound of :func:`fixed_point_scale` holds for
    each.

    :param keys: (..., n) int64 cell of each row, in [0, n_cells].
    :param rows: (..., n, d) int64 rows (:func:`to_fixed`).
    :return: (sums (..., n_cells, d) int64, counts (..., n_cells) int64).
    """
    order = torch.argsort(keys, dim=-1, stable=True)
    edges = torch.arange(n_cells + 1, device=keys.device)
    bounds = torch.searchsorted(
        torch.gather(keys, -1, order),
        edges.expand(*keys.shape[:-1], n_cells + 1).contiguous())
    # The prefix sum runs along the rows laid innermost, (..., d, n): a
    # scan over an outer dim takes one thread a column on a card.
    cols = torch.gather(rows, -2, order[..., None].expand(rows.shape)
                        ).transpose(-1, -2).contiguous()
    prefix = torch.cat([cols.new_zeros((*cols.shape[:-1], 1)),
                        torch.cumsum(cols, dim=-1)], dim=-1)
    at = torch.gather(prefix, -1, bounds[..., None, :].expand(
        *cols.shape[:-1], n_cells + 1))
    return ((at[..., 1:] - at[..., :-1]).transpose(-1, -2),
            bounds[..., 1:] - bounds[..., :-1])


def cell_means(sums: torch.Tensor, counts: torch.Tensor,
               scale: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """f32 means of the fixed-point ``sums`` over ``counts`` rows; a cell
    with no row keeps its ``old`` centroid."""
    mean = sums.double() / scale / torch.clamp(counts, min=1)[..., None]
    return torch.where(counts[..., None] > 0, mean.float(), old)


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
    valid = valid.bool()
    n, d = x.shape
    c = init.float().clone()
    c_count = c.shape[0]
    sign = _split_sign(c_count, d, x.device)
    amax = torch.where(valid[:, None], x.abs(), 0.0).amax(0) if n \
        else x.new_zeros(d)
    scale = fixed_point_scale(amax, n)
    # The rows never change: convert them once (8 bytes a value).
    x_fixed = to_fixed(x, scale) if n_iter else None
    for _ in range(n_iter):
        c_sq = (c * c).sum(-1)
        sums = torch.zeros((c_count, d), dtype=torch.int64, device=x.device)
        counts = torch.zeros(c_count, dtype=torch.int64, device=x.device)
        for lo in range(0, n, chunk):
            xb = x[lo:lo + chunk]
            a = torch.where(valid[lo:lo + chunk],
                            _assign_block(xb, c, c_sq), c_count)
            s_b, n_b = cell_sums(a, x_fixed[lo:lo + chunk], c_count)
            sums += s_b
            counts += n_b
        new_c = cell_means(sums, counts, scale, c)
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
    chunk = max(1, BATCHED_BYTES // (4 * m * c_count))
    require_full_f32(x)
    # One fixed-point scale a (problem, column).
    scale = fixed_point_scale(x.abs().amax(1, keepdim=True) if n
                              else x.new_zeros((m, 1, d)), n)
    x_fixed = to_fixed(x, scale) if n_iter else None
    for _ in range(n_iter):
        c_sq = (c * c).sum(-1)
        sums = torch.zeros((m, c_count, d), dtype=torch.int64,
                           device=x.device)
        counts = torch.zeros((m, c_count), dtype=torch.int64,
                             device=x.device)
        for lo in range(0, n, chunk):
            xb = x[:, lo:lo + chunk]
            # ||c||^2 - 2 <x, c> in one batched product; ties take the
            # lowest id, as jnp.argmin does.
            a = torch.argmin(torch.baddbmm(c_sq[:, None, :], xb,
                                           c.transpose(1, 2), alpha=-2.0),
                             dim=2)
            # One sort and one prefix sum a problem (cell_sums).
            s_b, n_b = cell_sums(a, x_fixed[:, lo:lo + chunk], c_count)
            sums += s_b
            counts += n_b
        new_c = cell_means(sums, counts, scale, c)
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
