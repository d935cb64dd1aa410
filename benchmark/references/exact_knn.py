"""
The plain reference of the exact flat configurations, and the comparison
that decides ``correct``.

Exact Euclidean k nearest neighbours in float64, straight from the raw
rows the recipe drew: chunks of rows on ``device``, the float64 squared
distances ``|q|^2 + |x|^2 - 2 q.x`` (rounding about 1e-13 of a squared
distance here), the k smallest merged chunk by chunk. Plain PyTorch; it
imports nothing of the program and takes nothing it made.

An answer is a query's returned (row ids, distances); the benchmark's row
ids are the uids it gave the descriptors. :func:`compare` reads, over a
sample of answers:

- ``malformed``: answers that are missing, short, hold a row twice or out
  of range, or whose distances are not finite and ascending (limit 0);
- ``rank_excess``: the largest share of the true k-th distance by which a
  returned row lies beyond it (an exact top-k reads 0 but for near ties);
- ``dist_err``: the largest gap between a returned distance and the
  float64 distance of the row it names, as a share of the true k-th
  distance;
- ``recall_at_10``: the mean share of the true top 10 among the first 10
  returned (not a compared number).

:func:`control` is the reference put in the program's place in the
nearest precision below the configuration's float32: TF32, its operands
rounded to TF32 (10 explicit mantissa bits) and their products summed in
float32, the distances taken in the matmul form.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

#: Bytes of float64 rows a chunk of the truth holds on the device.
CHUNK_BYTES = 1 << 30

#: (query pool index, row ids or None, distances or None).
Answer = Tuple[int, Optional[Sequence[int]], Optional[Sequence[float]]]


def _chunks(n: int, d: int, itemsize: int):
    rows = max(1, CHUNK_BYTES // (itemsize * d))
    for lo in range(0, n, rows):
        yield lo, min(lo + rows, n)


def truth(rows: np.ndarray, queries: np.ndarray, k: int, device: str
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Float64 exact top-``k``: (row ids (S, k), distances (S, k))."""
    q = torch.from_numpy(queries).to(device, torch.float64)
    q_sq = (q * q).sum(1, keepdim=True)
    best_d = torch.full((q.shape[0], k), math.inf, dtype=torch.float64,
                        device=device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                        device=device)
    for lo, hi in _chunks(rows.shape[0], rows.shape[1], 8):
        x = torch.from_numpy(rows[lo:hi]).to(device, torch.float64)
        d2 = q_sq + (x * x).sum(1)[None] - 2.0 * (q @ x.T)
        ids = torch.arange(lo, hi, device=device).expand(q.shape[0], -1)
        best_d, sel = torch.topk(torch.cat([best_d, d2], 1), k, dim=1,
                                 largest=False)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, sel)
    return (best_i.cpu().numpy(),
            np.sqrt(np.maximum(best_d.cpu().numpy(), 0.0)))


def row_dists(rows: np.ndarray, queries: np.ndarray,
              ids: np.ndarray) -> np.ndarray:
    """Float64 distances from each query to the rows ``ids`` (S, k)
    names, in the difference form."""
    x = rows[ids].astype(np.float64)
    diff = x - queries.astype(np.float64)[:, None, :]
    return np.sqrt(np.einsum("skd,skd->sk", diff, diff))


def _well_formed(ids, dists, k: int, n: int) -> bool:
    if ids is None or dists is None or len(ids) != k or len(dists) != k:
        return False
    if any(not isinstance(i, (int, np.integer)) or not 0 <= i < n
           for i in ids) or len(set(ids)) != k:
        return False
    d = np.asarray(dists, dtype=np.float64)
    return bool(np.all(np.isfinite(d)) and np.all(np.diff(d) >= 0))


def compare(answers: Sequence[Answer], rows: np.ndarray,
            pool: np.ndarray, k: int, device: str) -> dict:
    """The compared numbers (module docstring) of ``answers`` against the
    float64 truth over ``rows``; queries are ``pool[index]``."""
    good = [a for a in answers if _well_formed(a[1], a[2], k, len(rows))]
    out = {"malformed": len(answers) - len(good), "rank_excess": 0.0,
           "dist_err": 0.0, "recall_at_10": None}
    if not good:
        return out
    queries = pool[[a[0] for a in good]]
    ids = np.array([list(a[1]) for a in good], dtype=np.int64)
    got = np.array([list(a[2]) for a in good], dtype=np.float64)
    true_ids, true_d = truth(rows, queries, k, device)
    kth = true_d[:, -1:]
    scale = np.where(kth > 0, kth, 1.0)
    d64 = row_dists(rows, queries, ids)
    out["rank_excess"] = float(np.max(np.maximum(d64 - kth, 0.0) / scale))
    out["dist_err"] = float(np.max(np.abs(got - d64) / scale))
    top = min(10, k)
    out["recall_at_10"] = float(np.mean([
        len(set(g[:top].tolist()) & set(t[:top].tolist())) / top
        for g, t in zip(ids, true_ids)]))
    return out


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32, to nearest, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def control(rows: np.ndarray, queries: np.ndarray, k: int, device: str
            ) -> List[Tuple[List[int], List[float]]]:
    """Top-``k`` in TF32: (row ids, distances) a query."""
    q = torch.from_numpy(queries).to(device, torch.float32)
    q_sq = (q * q).sum(1, keepdim=True)
    qt = to_tf32(q)
    best_d = torch.full((q.shape[0], k), math.inf, device=device)
    best_i = torch.full((q.shape[0], k), -1, dtype=torch.int64,
                        device=device)
    for lo, hi in _chunks(rows.shape[0], rows.shape[1], 4):
        x = torch.from_numpy(rows[lo:hi]).to(device, torch.float32)
        x_sq = (x * x).sum(1)
        ip = qt @ to_tf32(x).T
        d2 = q_sq + x_sq[None] - 2.0 * ip
        ids = torch.arange(lo, hi, device=device).expand(q.shape[0], -1)
        best_d, sel = torch.topk(torch.cat([best_d, d2], 1), k, dim=1,
                                 largest=False)
        best_i = torch.gather(torch.cat([best_i, ids], 1), 1, sel)
    d = torch.sqrt(torch.clamp(best_d, min=0.0)).cpu().tolist()
    return list(zip(best_i.cpu().tolist(), d))
