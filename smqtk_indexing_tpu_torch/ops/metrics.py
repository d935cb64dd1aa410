"""
Batched distance metrics on the device, in f32: the port of
``smqtk_indexing_tpu/ops/metrics.py``.

The JAX functions run their products at ``Precision.HIGHEST``; here the
matrix products check ``ops/device.require_full_f32`` (a TF32 product on
the card raises), and ``candidate_distances`` sums elementwise products,
which are full f32 on every device.
"""
import math

import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32


def _mm(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, d) x (N, d)^T in full f32."""
    q, x = q.float(), x.float()
    require_full_f32(q)
    return q @ x.T


def euclidean_distance_many(q: torch.Tensor, x: torch.Tensor
                            ) -> torch.Tensor:
    """(B, d) queries vs (N, d) points -> (B, N) Euclidean distances."""
    q, x = q.float(), x.float()
    q_sq = (q * q).sum(-1, keepdim=True)
    x_sq = (x * x).sum(-1)
    d2 = torch.clamp(q_sq + x_sq[None, :] - 2.0 * _mm(q, x), min=0.0)
    return torch.sqrt(d2)


def cosine_distance_many(q: torch.Tensor, x: torch.Tensor,
                         pos_vectors: bool = True) -> torch.Tensor:
    """(B, d) vs (N, d) -> (B, N) angular distances in [0, 1]."""
    q, x = q.float(), x.float()
    qn = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    xn = torch.linalg.vector_norm(x, dim=-1)
    denom = qn * xn[None, :]
    denom = torch.where(denom == 0, 1.0, denom)
    sim = torch.clamp(_mm(q, x) / denom, -1.0, 1.0)
    return (1 + bool(pos_vectors)) * torch.arccos(sim) / math.pi


def hik_distance_many(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, d) vs (N, d) -> (B, N) histogram intersection distances."""
    return 1.0 - torch.minimum(q.float()[:, None, :],
                               x.float()[None, :, :]).sum(-1)


def inner_product_many(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, d) vs (N, d) -> (B, N) inner products."""
    return _mm(q, x)


def candidate_distances(q: torch.Tensor, cand: torch.Tensor,
                        metric: str) -> torch.Tensor:
    """
    Per-query candidate distances: (B, d) queries vs per-query (B, M, d)
    candidate rows -> (B, M), with the math of the reference's re-rank
    metrics (SMQTK-Indexing smqtk_indexing/impls/nn_index/lsh.py:507-518)
    in the elementwise form of ``ops/metrics.py:46-69`` (no matrix
    product).

    :raises ValueError: unknown ``metric``.
    """
    qb = q.float()[:, None, :]
    cand = cand.float()
    if metric == "euclidean":
        diff = cand - qb
        return torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0))
    if metric == "cosine":
        qn = torch.linalg.vector_norm(qb, dim=-1)
        cn = torch.linalg.vector_norm(cand, dim=-1)
        denom = qn * cn
        denom = torch.where(denom == 0, 1.0, denom)
        sim = torch.clamp((cand * qb).sum(-1) / denom, -1.0, 1.0)
        return 2.0 * torch.arccos(sim) / math.pi
    if metric == "hik":
        return 1.0 - torch.minimum(qb, cand).sum(-1)
    raise ValueError(f"Unknown distance method '{metric}'.")
