"""
PQ (product quantization) codec and exhaustive scan, in PyTorch.

Counterpart of ``smqtk_indexing_tpu/ops/pq.py:1-448``. The d codec dims
split into M subspaces, each quantized to one of ``K_SUB`` = 256 learned
centroids, so a vector is M bytes. The JAX module imports jax, so its host
functions are re-written here: the same numpy draws (``pq_train``'s init),
the same dim interleave and the same float64 host arithmetic, so both
packages build the same codec grid from the same rows.

- Training (``pq_train``) runs the M subspaces' Lloyd iterations as one
  batched problem (``ops/kmeans.kmeans_lloyd_batched``), and encoding
  (``pq_encode_np``) a batched full-f32 product, both on ``device``.
- ``_dequant`` decodes codes by an index gather ``cb[m, codes[:, m]]``:
  exact, with no one-hot product. Codes are read as unsigned bytes (a
  uint8 tensor, or the JAX package's int8 bit pattern masked with 0xFF).
- ``pq_topk`` is the flat store's scan: dequantize-then-scan in f32 through
  ``ops/scan.codec_topk``, exact with respect to the reconstructions. The
  JAX package ranks with bf16 codebooks and products (``pq.py:376-378``);
  the port ranks in f32 (ROADMAP queue 3).

Because subspaces partition the dims, ``||x_hat||^2 = sum_m ||c_m||^2``;
``pq_row_stats`` sums that table in m order.
"""
from __future__ import annotations

import re
from typing import Optional, Tuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.device import pad_rows_np, require_full_f32
from smqtk_indexing_tpu_torch.ops.kmeans import kmeans_lloyd_batched
from smqtk_indexing_tpu_torch.ops.scan import (
    ELEMENTWISE_BYTES, codec_topk, hik_scores,
)

PQ_METRICS = ("euclidean", "inner_product", "cosine", "hik")

#: Rows per streamed block (divides every 1024 * 2^m capacity).
DEFAULT_CHUNK = 65536

#: Centroids per subspace (8-bit codes, the FAISS PQ default).
K_SUB = 256

#: Cap on ``pq_encode_np``'s (M, rows, K_SUB) f32 score block.
ENCODE_BYTES = 1 << 28

_PQ_RE = re.compile(r"(o?)pq(\d+)")


def pq_m(dtype_name: str) -> Optional[int]:
    """Subquantizer count of a 'pq<M>' / 'opq<M>' dtype name, else None."""
    m = _PQ_RE.fullmatch(dtype_name)
    return int(m.group(2)) if m else None


def pq_rotate(dtype_name: str) -> bool:
    """True for the OPQ dtype names ('opq<M>')."""
    m = _PQ_RE.fullmatch(dtype_name)
    return bool(m and m.group(1))


def pq_codec_dim(d_pad: int, m: int) -> int:
    """Codec-grid width: the padded dim rounded up to a multiple of M, so
    an M that does not divide it (d=96 with PQ12: 132) still builds; the
    extra zero dims quantize exactly and add nothing to any metric."""
    return -(-d_pad // m) * m


def pq_perm(d_codec: int, m: int) -> np.ndarray:
    """(d_codec,) int32 round-robin dim interleave over the M subspaces
    (zero padding would otherwise pack every real dim into the first
    subspaces)."""
    return np.argsort(np.arange(d_codec) % m, kind="stable").astype(np.int32)


def pq_train(mat: np.ndarray, m: int, n_iter: int = 20, seed: int = 0,
             init: Optional[np.ndarray] = None, device="cpu") -> np.ndarray:
    """
    Learn per-subspace codebooks: one batched Lloyd run over the M
    subspaces on ``device``.

    :param mat: (n, d) float32 training rows (d % m == 0).
    :param m: Subquantizer count (bytes per vector).
    :param init: Optional (m, 256, d // m) warm-start codebooks (the OPQ
        alternation carries codebooks across rotation updates). Without
        it, the init is ``pq.py:67-77``'s numpy draw: 256 distinct rows
        (duplicates padding the draw when n < 256).
    :return: (m, 256, d // m) float32 codebooks.
    """
    n, d = mat.shape
    if d % m:
        raise ValueError(f"dim {d} not divisible by {m} subquantizers")
    dsub = d // m
    subs = np.ascontiguousarray(
        mat.reshape(n, m, dsub).transpose(1, 0, 2).astype(np.float32))
    if init is None:
        rng = np.random.default_rng(seed)
        k_eff = min(K_SUB, n)
        init = subs[:, rng.choice(n, k_eff, replace=False)]
        if k_eff < K_SUB:
            init = np.concatenate(
                [init, init[:, rng.integers(0, k_eff, K_SUB - k_eff)]],
                axis=1)
    cents = kmeans_lloyd_batched(
        torch.from_numpy(subs).to(device),
        torch.from_numpy(np.array(init, np.float32)).to(device),
        n_iter=n_iter)
    return cents.cpu().numpy()


def pq_encode_np(mat: np.ndarray, codebooks: np.ndarray,
                 device="cpu") -> np.ndarray:
    """(n, d) float32 rows -> (n, M) uint8 codes of the nearest codeword
    per subspace, in full f32 on ``device``; a tie takes the lowest id, as
    ``jnp.argmin`` does."""
    n, d = mat.shape
    m, k_sub, dsub = codebooks.shape
    cb = torch.from_numpy(np.array(codebooks, np.float32)).to(device)
    c_sq = (cb * cb).sum(-1)                              # (M, K)
    rows = max(1, ENCODE_BYTES // (4 * m * k_sub))
    codes = np.zeros((n, m), dtype=np.uint8)
    for lo in range(0, n, rows):
        blk = torch.from_numpy(np.ascontiguousarray(
            mat[lo:lo + rows], np.float32)).to(device)
        subs = blk.view(-1, m, dsub).transpose(0, 1)      # (M, rows, dsub)
        require_full_f32(subs)
        # ||c||^2 - 2 <x, c>, (M, rows, K), in one batched product.
        score = torch.baddbmm(c_sq[:, None, :], subs, cb.transpose(1, 2),
                              alpha=-2.0)
        codes[lo:lo + rows] = torch.argmin(score, dim=2).T \
            .to(torch.uint8).cpu().numpy()
    return codes


def pq_decode_np(codes: np.ndarray, codebooks: np.ndarray) -> np.ndarray:
    """(n, M) uint8 -> (n, d) float32 reconstruction (host)."""
    return np.concatenate(
        [codebooks[mi][codes[:, mi]] for mi in range(codebooks.shape[0])],
        axis=1)


def pq_prep_queries(q_pad: np.ndarray, perm: np.ndarray,
                    rot: Optional[np.ndarray] = None) -> np.ndarray:
    """Extend padded rows to the codec grid, interleave and (OPQ) rotate:
    the one row-side transform of every PQ path (host)."""
    b, dp = q_pad.shape
    if len(perm) > dp:
        q_pad = np.concatenate(
            [q_pad, np.zeros((b, len(perm) - dp), q_pad.dtype)], axis=1)
    q_c = q_pad[:, perm]
    return q_c @ rot if rot is not None else q_c


def pq_transform_queries(q: torch.Tensor,
                         transform: torch.Tensor) -> torch.Tensor:
    """
    The device form of :func:`pq_prep_queries` (``pallas_ivf.py:1019-1032``).

    :param q: (B, d_pad) f32 queries.
    :param transform: (d_codec,) integer dim interleave, or the
        (d_codec, d_codec) f32 interleave-and-rotation matrix of
        ``ops/opq.compose_transform`` (applied in full f32).
    :return: (B, d_codec) f32 codec-grid queries.
    """
    q = q.float()
    d_codec = transform.shape[0]
    if d_codec > q.shape[1]:
        q = torch.cat([q, q.new_zeros((q.shape[0], d_codec - q.shape[1]))],
                      dim=1)
    if transform.dim() == 2:
        require_full_f32(q)
        return q @ transform.float()
    return q[:, transform.long()]


def _dequant(codes: torch.Tensor, cb: torch.Tensor) -> torch.Tensor:
    """(..., M) codes -> (..., M * dsub) f32 reconstruction, by an index
    gather (exact). Codes read as unsigned bytes: uint8, or int8 holding
    the uint8 bit pattern."""
    m, _, dsub = cb.shape
    idx = codes.long() & 0xFF
    x = cb[torch.arange(m, device=cb.device), idx]        # (..., M, dsub)
    return x.reshape(*codes.shape[:-1], m * dsub)


def pq_row_stats(codes: torch.Tensor, codebooks: torch.Tensor
                 ) -> torch.Tensor:
    """(N,) f32 squared reconstruction norms: ``sum_m ||c_{m, code_m}||^2``
    from the f32 codeword-norm table, summed in m order."""
    cb_sq = (codebooks * codebooks).sum(-1)               # (M, K)
    idx = codes.long() & 0xFF
    s = torch.zeros(codes.shape[0], device=codes.device)
    for mi in range(codes.shape[1]):
        s = s + cb_sq[mi][idx[:, mi]]
    return s


def pq_residual_stats(codes: torch.Tensor, codebooks: torch.Tensor,
                      cents_c: torch.Tensor, row2list: torch.Tensor,
                      chunk: int = DEFAULT_CHUNK) -> torch.Tensor:
    """(N,) f32 ``||c_T[row2list] + r_hat||^2``: the residual codec's full
    reconstruction norms, decoded in row chunks."""
    out = []
    for lo in range(0, codes.shape[0], chunk):
        x = _dequant(codes[lo:lo + chunk], codebooks) \
            + cents_c[row2list[lo:lo + chunk].long()]
        out.append((x * x).sum(-1))
    return torch.cat(out)


def _train_codec(live: np.ndarray, m: int, rotate: bool, seed: int,
                 device):
    """(rot | None, codebooks) trained on codec-grid rows."""
    if rotate:
        from smqtk_indexing_tpu_torch.ops.opq import opq_train
        return opq_train(live, m, seed=seed, device=device)
    return None, pq_train(live, m, device=device)


def pq_build_store(host: np.ndarray, valid_mask: np.ndarray, capacity: int,
                   d_pad: int, m: int, device, rotate: bool = False,
                   seed: int = 0, codec=None):
    """
    The one shared PQ store build (``pq.py:136-186``; the flat store and
    the IVF rows tier): the dim interleave over the codec grid, codebooks
    (and with ``rotate`` an OPQ rotation composed after the interleave)
    trained over the live rows, or ``codec`` reused, the encode and the
    reconstruction-norm stats.

    :param host: (n, dim) float32 raw rows.
    :param codec: (perm, rot, codebooks) of an earlier build: the
        train-once contract across capacity growth and compaction.
    :return: (perm (d_codec,) int32, rot (d_codec, d_codec) f32 | None,
        codebooks np (m, 256, dsub), codebooks tensor, codes tensor
        (capacity, m) uint8, s2 tensor (capacity,) f32), tensors on
        ``device``.
    """
    if m > host.shape[1]:
        raise ValueError(
            f"PQ{m}: more subquantizers than dims ({host.shape[1]}).")
    d_codec = pq_codec_dim(d_pad, m)
    n = host.shape[0]
    if codec is not None:
        perm, rot, cb = codec
    else:
        perm = pq_perm(d_codec, m)
        live = host[valid_mask] if not valid_mask.all() else host
        rot, cb = _train_codec(
            pad_rows_np(live, live.shape[0], d_codec)[:, perm], m, rotate,
            seed, device)
    codes = np.zeros((capacity, m), dtype=np.uint8)
    codes[:n] = pq_encode_np(pq_prep_queries(host, perm, rot), cb,
                             device=device)
    cb_dev = torch.from_numpy(np.array(cb, np.float32)).to(device)
    codes_dev = torch.from_numpy(codes).to(device)
    return perm, rot, cb, cb_dev, codes_dev, pq_row_stats(codes_dev, cb_dev)


def pq_residual_build_store(host: np.ndarray, valid_mask: np.ndarray,
                            capacity: int, d_pad: int, m: int,
                            cents_pad: np.ndarray, assigns: np.ndarray,
                            device, rotate: bool = False, seed: int = 0):
    """
    Residual-encoded IVF-PQ build (``pq.py:189-246``, FAISS's
    ``by_residual``): the codec quantizes ``x_T - c_T[list]`` in the codec
    space T (interleave, and an OPQ rotation learned on the residuals).

    :param host: (n, dim) float32 rows in list-sorted order.
    :param cents_pad: (C, d_pad) float32 padded centroids.
    :param assigns: (n,) int32 list of each row.
    :return: (perm, rot | None, codebooks np, codebooks tensor, codes
        tensor (capacity, m) uint8, s2 tensor (capacity,) f32
        (``||c_T + r_hat||^2``), cents_T np (C, d_codec) f32, row2list
        tensor (capacity,) int32).
    """
    if m > host.shape[1]:
        raise ValueError(
            f"PQ{m}: more subquantizers than dims ({host.shape[1]}).")
    d_codec = pq_codec_dim(d_pad, m)
    perm = pq_perm(d_codec, m)
    n = host.shape[0]
    cents_c = pq_prep_queries(cents_pad.astype(np.float32), perm)
    res = pq_prep_queries(host, perm) - cents_c[assigns]
    live = res[valid_mask] if not valid_mask.all() else res
    rot, cb = _train_codec(live, m, rotate, seed, device)
    if rot is not None:
        res = res @ rot
        cents_c = np.ascontiguousarray(cents_c @ rot)
    codes = np.zeros((capacity, m), dtype=np.uint8)
    codes[:n] = pq_encode_np(res, cb, device=device)
    row2list = np.zeros(capacity, dtype=np.int32)
    row2list[:n] = assigns
    cb_dev = torch.from_numpy(np.array(cb, np.float32)).to(device)
    codes_dev = torch.from_numpy(codes).to(device)
    row2list_dev = torch.from_numpy(row2list).to(device)
    s2 = pq_residual_stats(codes_dev, cb_dev,
                           torch.from_numpy(cents_c).to(device),
                           row2list_dev)
    return perm, rot, cb, cb_dev, codes_dev, s2, cents_c, row2list_dev


def pq_topk(codes: torch.Tensor, codebooks: torch.Tensor, s2: torch.Tensor,
            valid: torch.Tensor, q: torch.Tensor, *, k: int,
            metric: str = "euclidean", chunk: int = DEFAULT_CHUNK
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Exhaustive top-k over a PQ-coded database (``pq.py:340-448``):
    dequantize-then-scan in f32, a k + 8 margin, and an exact re-rank of
    the winners from their f32 reconstructions, so distances are exact
    with respect to the reconstructions.

    :param codes: (N, M) uint8 codes (dead rows anything; masked).
    :param codebooks: (M, 256, dsub) float32.
    :param s2: (N,) float32 squared reconstruction norms.
    :param valid: (N,) bool row liveness.
    :param q: (B, M * dsub) float32 codec-grid queries.
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    """
    if metric not in PQ_METRICS:
        raise ValueError(
            f"metric must be one of {PQ_METRICS}, got {metric!r}")
    n = codes.shape[0]
    q = q.float()
    q_norm = torch.sqrt((q * q).sum(-1))
    d = q.shape[1]

    def surrogate(ip, s2_sel, qn):
        if metric == "inner_product":
            return -ip
        if metric == "cosine":
            denom = qn * torch.sqrt(torch.clamp(s2_sel, min=0.0))
            return -(ip / torch.where(denom == 0, 1.0, denom))
        return s2_sel - 2.0 * ip

    def score_block(lo, hi):
        x = _dequant(codes[lo:hi], codebooks)
        if metric == "hik":
            return hik_scores(q, x)
        require_full_f32(q)
        return surrogate(q @ x.T, s2[None, lo:hi], q_norm[:, None])

    def score_rows(q0, q1, rows):
        x = _dequant(codes[rows], codebooks)               # (b, R, d)
        qb = q[q0:q1, None, :]
        if metric == "hik":
            return 1.0 - torch.minimum(qb, x).sum(-1)
        return surrogate((x * qb).sum(-1), s2[rows], q_norm[q0:q1, None])

    block = chunk if metric != "hik" else \
        max(128, ELEMENTWISE_BYTES // (4 * max(q.shape[0], 1) * d)
            // 128 * 128)
    return codec_topk(score_block, score_rows,
                      lambda rows: _dequant(codes[rows], codebooks), valid,
                      q, q_norm, n=n, k=k, metric=metric, chunk=chunk,
                      block=block, row_bytes=8 * d)
