"""
OPQ (optimized product quantization) rotation training.

Counterpart of ``smqtk_indexing_tpu/ops/opq.py:35-146``, whose
``opq_train`` imports the JAX package's PQ functions: here it calls the
port's (``ops/pq.py``), on ``device``. An orthogonal R is learned to
minimize the PQ reconstruction error ``||X R - dec(enc(X R))||_F`` (Ge et
al., "Optimized Product Quantization", CVPR 2013) before product
quantization. Euclidean, inner-product and cosine scores are rotation
invariant, so only the row encode and the query transform change: R
composes after the dim interleave (``compose_transform``).

The alternation's k-means and encode run on ``device``; the Procrustes
update is one (d, d) float64 SVD on the host, fed by a float64 host
product, exactly as in the JAX package. The numpy sample draw is the JAX
package's, so one seed samples the same rows in both.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from smqtk_indexing_tpu_torch.ops.pq import (
    pq_decode_np, pq_encode_np, pq_train,
)

#: Training-sample cap: 32K rows bound the alternation's k-means cost
#: while leaving >= 128 rows a codeword at d <= 1024.
DEFAULT_SAMPLE = 32768


def eig_alloc_init(rows_c: np.ndarray, m: int) -> np.ndarray:
    """Eigenvalue-allocation initial rotation (Ge et al. section 4,
    OPQ-P): PCA directions dealt greedily to the M subspaces, balancing
    each bucket's log-eigenvalue product.

    :param rows_c: (n, d_codec) float32 codec-grid rows.
    :param m: Subquantizer count (d_codec % m == 0).
    :return: (d_codec, d_codec) float32 orthogonal init.
    """
    d = rows_c.shape[1]
    dsub = d // m
    mu = rows_c.mean(axis=0, dtype=np.float64)
    cov = np.cov((rows_c.astype(np.float64) - mu).T)
    w, v = np.linalg.eigh(np.atleast_2d(cov))
    w, v = w[::-1], v[:, ::-1]                       # descending variance
    buckets: list = [[] for _ in range(m)]
    load = np.zeros(m)
    for i in range(d):
        free = [b for b in range(m) if len(buckets[b]) < dsub]
        b = min(free, key=lambda j: load[j])
        buckets[b].append(i)
        load[b] += np.log(max(w[i], 1e-12))
    order = np.concatenate([np.asarray(b, dtype=np.int64)
                            for b in buckets])
    return np.ascontiguousarray(v[:, order]).astype(np.float32)


def opq_train(rows_c: np.ndarray, m: int, n_iter: int = 16, seed: int = 0,
              sample: int = DEFAULT_SAMPLE, inner_kmeans_iter: int = 4,
              final_kmeans_iter: int = 20, init: str = "identity",
              device="cpu") -> Tuple[np.ndarray, np.ndarray]:
    """
    Learn the OPQ rotation and the final codebooks (``opq.py:63-130``).

    Alternation (OPQ-NP): per-subspace k-means on the rotated sample (few
    Lloyd steps, warm-started from the previous codebooks), encode and
    decode, then the orthogonal-Procrustes update ``R = U V^T`` with
    ``U S V^T = svd(X^T X_hat)``. The best-error (R, codebooks) seen is
    kept, and a final full-strength k-means on it gives the codebooks
    served. ``init="identity"`` is the default, as in the JAX package (the
    eigenvalue allocation is a poor near-fixed point on clustered data).

    :param rows_c: (n, d_codec) float32 codec-grid rows (the interleave
        already applied).
    :param m: Subquantizer count.
    :param init: "identity" | "eig" (:func:`eig_alloc_init`).
    :return: (R (d_codec, d_codec) float32 orthogonal, codebooks
        (m, 256, d_codec // m) float32); encode with ``rows_c @ R``.
    """
    n, d = rows_c.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} subquantizers")
    if init not in ("identity", "eig"):
        raise ValueError(f"init must be 'identity' | 'eig', got {init!r}")
    if n > sample:
        sel = np.random.default_rng(seed).choice(n, sample, replace=False)
        x = np.ascontiguousarray(rows_c[sel]).astype(np.float32)
    else:
        x = np.asarray(rows_c, dtype=np.float32)
    r = eig_alloc_init(x, m) if init == "eig" \
        else np.eye(d, dtype=np.float32)
    x64 = x.astype(np.float64)
    cb = None
    best = (np.inf, r, None)
    for _ in range(n_iter):
        xr = x @ r
        cb = pq_train(xr, m, n_iter=inner_kmeans_iter, seed=seed, init=cb,
                      device=device)
        rec = pq_decode_np(pq_encode_np(xr, cb, device=device), cb)
        err = float(((xr - rec) ** 2).sum())
        if err < best[0]:
            best = (err, r, cb)
        u, _, vt = np.linalg.svd(x64.T @ rec.astype(np.float64))
        r = (u @ vt).astype(np.float32)
    _, r, cb = best
    cb = pq_train(np.ascontiguousarray(x @ r), m, n_iter=final_kmeans_iter,
                  seed=seed, init=cb, device=device)
    return r, cb


def compose_transform(perm: np.ndarray, rot: np.ndarray) -> np.ndarray:
    """The dim interleave and the OPQ rotation folded into one
    (d_codec, d_codec) matrix T, ``q_codec = q_ext @ T`` (``opq.py:133-146``).

    :param perm: (d_codec,) int dim interleave (codec <- extended).
    :param rot: (d_codec, d_codec) float32 orthogonal.
    """
    d = len(perm)
    p = np.zeros((d, d), dtype=np.float32)
    p[np.asarray(perm), np.arange(d)] = 1.0
    return np.ascontiguousarray(p @ rot)
