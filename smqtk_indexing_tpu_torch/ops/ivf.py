"""
IVF (inverted-file) probe selection and the plain list-gather scan.

Counterpart of ``smqtk_indexing_tpu/ops/ivf.py:24-178``. The database is
sorted by coarse-cluster id, so every inverted list is a contiguous row
range (CSR: a start and a length per list). A query batch scores the
centroids, selects the lists to probe (``probe_eligibility``: FAISS's
nprobe, counted in original lists), gathers their rows, scores them with
the flat scan's surrogates, and re-ranks the winners exactly
(``ops/scan._exact_selected``).

``ivf_query`` serves what no kernel serves: the rows tier's inner_product
and cosine, and layouts whose lists are longer than the row-major
kernel's window (``ops/ivf_scan.L_MAX - 32``). It gathers the
(b, nprobe * l_max, d) candidate block in f32, so queries run in blocks
that keep it under ``GATHER_BYTES``. ``ivf_query_pq`` is its PQ form
(``ivf.py:181-324``): the rows tier's inner_product and cosine over PQ
codes, decoded by ``ops/pq._dequant`` and ranked in f32 (the JAX package
ranks with bf16 codebooks and products, ``ivf.py:279-286``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from smqtk_indexing_tpu_torch.ops.device import require_full_f32
from smqtk_indexing_tpu_torch.ops.pq import _dequant
from smqtk_indexing_tpu_torch.ops.scan import (
    _exact_selected, exact_rerank_decoded, pad_to_k,
)
from smqtk_indexing_tpu_torch.ops.sq8 import sq8_decode

METRICS = ("euclidean", "inner_product", "cosine")

#: Cap on ``ivf_query``'s (b, nprobe * l_max, d) f32 candidate block.
GATHER_BYTES = 1 << 28


def centroid_scores(q: torch.Tensor, c: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """(B, C) probe-ranking surrogates of f32 queries against f32
    centroids, lower = nearer, in full f32."""
    require_full_f32(q)
    ip_c = q @ c.T
    if metric == "inner_product":
        return -ip_c
    c_sq = (c * c).sum(-1)
    if metric == "cosine":
        denom = torch.sqrt((q * q).sum(-1))[:, None] \
            * torch.sqrt(c_sq)[None, :]
        return -(ip_c / torch.where(denom == 0, 1.0, denom))
    return c_sq[None, :] - 2.0 * ip_c


def smallest(scores: torch.Tensor, k: int):
    """The ``k`` smallest entries of each row, ascending, ties to the lower
    index: the order of ``jax.lax.top_k`` on negated scores. Probe
    selection needs it, because every sublist of one list carries a
    bitwise-equal centroid score."""
    vals, idx = torch.sort(scores, dim=1, stable=True)
    return vals[:, :k], idx[:, :k]


def probe_eligibility(c_scores_raw: torch.Tensor, lens: torch.Tensor,
                      first_virt: Optional[torch.Tensor],
                      nprobe_orig: Optional[int]) -> torch.Tensor:
    """
    FAISS-faithful nprobe (``ivf.py:27-68``): ``nprobe`` counts ORIGINAL
    lists ranked by centroid score, and exactly those lists' sublists are
    scanned. Sublists of one list share a bitwise-equal score, so the
    original ranking is read at one representative slot per list
    (``first_virt``); a slot is eligible iff its score is <= the
    nprobe_orig-th best original score.

    :param c_scores_raw: (B, V) unmasked centroid scores over the virtual
        sublists (empty lists included, as FAISS ranks them).
    :param lens: (V,) sublist lengths.
    :param first_virt: (C,) representative slot per original list, or None
        to rank virtual sublists directly.
    :param nprobe_orig: original lists to probe, or None.
    :return: (B, V) scores with ineligible or empty slots at +inf.
    """
    masked = torch.where(lens[None, :] > 0, c_scores_raw, math.inf)
    if first_virt is None or nprobe_orig is None \
            or nprobe_orig >= first_virt.shape[0]:
        return masked
    orig = c_scores_raw[:, first_virt]
    thresh = torch.topk(orig, nprobe_orig, dim=1, largest=False,
                        sorted=True).values[:, -1]
    return torch.where(c_scores_raw <= thresh[:, None], masked, math.inf)


def select_probes(c_scores: torch.Tensor, lens: torch.Tensor, nprobe: int):
    """The ``nprobe`` best eligible slots per query: (B, nprobe) slot ids
    and their lengths, 0 for budget slots past the eligible lists."""
    vals, lists = smallest(c_scores, nprobe)
    return lists, torch.where(torch.isfinite(vals), lens[lists], 0)


def ivf_query(db: torch.Tensor, db_sq: torch.Tensor, db_norm: torch.Tensor,
              valid: torch.Tensor, centroids: torch.Tensor,
              offsets: torch.Tensor, lens: torch.Tensor, q: torch.Tensor, *,
              k: int, nprobe: int, l_max: int, metric: str = "euclidean",
              dq=None, first_virt=None, nprobe_orig=None,
              has_dead: bool = True):
    """
    IVF query by list gather (``ivf.py:71-178``).

    :param db: (N, d) database sorted by list id (zero-padded); int8 SQ8
        codes when ``dq`` is given.
    :param db_sq: (N,) squared L2 norms (of the dequantized rows for SQ8).
    :param db_norm: (N,) L2 norms.
    :param valid: (N,) bool liveness.
    :param centroids: (V, d) centroids of the virtual sublists.
    :param offsets: (V,) start row of each sublist.
    :param lens: (V,) length of each sublist.
    :param q: (B, d) float32 queries.
    :param k: neighbours per query.
    :param nprobe: virtual probe-slot budget (<= V).
    :param l_max: padded sublist length (>= max(lens)).
    :param dq: optional (a, b) SQ8 codec tensors.
    :param first_virt: optional (C,) representative slot per original list.
    :param nprobe_orig: original lists to probe (with ``first_virt``).
    :param has_dead: False skips the per-row liveness gather.
    :return: (dists (B, k) float32 ascending, rows (B, k) int64 into the
        sorted layout; +inf / -1 past the candidates).
    """
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    n, d = db.shape
    q = q.float()
    q_sq = (q * q).sum(-1)
    q_norm = torch.sqrt(q_sq)
    # Centroids stay float over int8 codes; over a bf16 database the
    # centroids and the query take its rounding, as ivf.py:113-121 does.
    c_dt = torch.float32 if dq is not None else db.dtype
    c_scores = centroid_scores(q.to(c_dt).float(),
                               centroids.to(c_dt).float(), metric)
    c_scores = probe_eligibility(c_scores, lens, first_virt, nprobe_orig)
    lists, lengths = select_probes(c_scores, lens, nprobe)
    starts = offsets[lists].long()

    ii = torch.arange(l_max, device=db.device)
    k_inner = min(k, nprobe * l_max)
    q_block = max(1, GATHER_BYTES // (4 * nprobe * l_max * d))
    top_s, top_r = [], []
    for lo in range(0, q.shape[0], q_block):
        hi = min(lo + q_block, q.shape[0])
        rows = (starts[lo:hi, :, None] + ii).reshape(hi - lo, -1)
        mask = (ii < lengths[lo:hi, :, None]).reshape(hi - lo, -1)
        rows = torch.clamp(rows, 0, n - 1)
        if has_dead:
            mask = mask & valid[rows]
        cand = db[rows].float() if dq is None \
            else sq8_decode(db[rows], dq[0], dq[1])
        ip = (cand * q[lo:hi, None, :]).sum(-1)
        if metric == "inner_product":
            scores = -ip
        elif metric == "cosine":
            denom = q_norm[lo:hi, None] * db_norm[rows]
            scores = -(ip / torch.where(denom == 0, 1.0, denom))
        else:
            scores = db_sq[rows] - 2.0 * ip
        scores = torch.where(mask, scores, math.inf)
        s, sel = torch.topk(scores, k_inner, dim=1, largest=False)
        r = torch.gather(rows, 1, sel)
        top_s.append(s)
        top_r.append(torch.where(torch.isinf(s), -1, r))
    top_s, top_r = pad_to_k(torch.cat(top_s), torch.cat(top_r), k)
    return _exact_selected(metric, db, q, q_sq, top_s, top_r, dq=dq)


def ivf_query_pq(codes: torch.Tensor, codebooks: torch.Tensor,
                 s2: torch.Tensor, valid: torch.Tensor,
                 centroids: torch.Tensor, offsets: torch.Tensor,
                 lens: torch.Tensor, q: torch.Tensor, *, k: int, nprobe: int,
                 l_max: int, metric: str = "euclidean", first_virt=None,
                 nprobe_orig=None, has_dead: bool = True, res_cents=None,
                 row2list=None):
    """
    IVF list scan over PQ codes (``ivf.py:181-324``): the probe selection
    of :func:`ivf_query`, the probed lists' codes decoded in f32, the top
    ``k + 8`` by the surrogate, and an exact re-rank from the winners' f32
    reconstructions.

    Residual mode (``res_cents`` and ``row2list`` given, FAISS
    ``by_residual``): codes carry ``x_T - c_T[list]``, ``s2`` holds
    ``||c_T + r_hat||^2``, the score adds each probe's ``-2 <q, c>``, and
    the re-rank adds the winner's centroid back. Euclidean only.

    :param codes: (N, M) uint8 codes in list-sorted order.
    :param codebooks: (M, 256, dsub) float32.
    :param s2: (N,) float32 squared reconstruction norms.
    :param centroids: (V, d_codec) sublist centroids on the codec grid.
    :param q: (B, d_codec) float32 codec-grid queries.
    :param res_cents: (C, d_codec) float32 codec-space centroids.
    :param row2list: (N,) int32 list of each row.
    :return: (dists (B, k) ascending, rows (B, k) int64; +inf / -1 pads).
    """
    if metric not in METRICS:
        raise ValueError(f"metric must be one of {METRICS}, got {metric!r}")
    residual = res_cents is not None
    if residual and metric != "euclidean":
        raise ValueError("residual PQ serves euclidean only")
    n = codes.shape[0]
    d = q.shape[1]
    q = q.float()
    q_norm = torch.sqrt((q * q).sum(-1))
    c = centroids.float()
    require_full_f32(q)
    ip_c = q @ c.T
    if metric == "inner_product":
        c_scores = -ip_c
    elif metric == "cosine":
        denom = q_norm[:, None] * torch.sqrt((c * c).sum(-1))[None, :]
        c_scores = -(ip_c / torch.where(denom == 0, 1.0, denom))
    else:
        c_scores = (c * c).sum(-1)[None, :] - 2.0 * ip_c
    c_scores = probe_eligibility(c_scores, lens, first_virt, nprobe_orig)
    lists, lengths = select_probes(c_scores, lens, nprobe)
    starts = offsets[lists].long()

    ii = torch.arange(l_max, device=codes.device)
    kk = min(k + 8, nprobe * l_max)
    q_block = max(1, GATHER_BYTES // (8 * nprobe * l_max * d))
    top_s, top_r = [], []
    for lo in range(0, q.shape[0], q_block):
        hi = min(lo + q_block, q.shape[0])
        rows = (starts[lo:hi, :, None] + ii).reshape(hi - lo, -1)
        mask = (ii < lengths[lo:hi, :, None]).reshape(hi - lo, -1)
        rows = torch.clamp(rows, 0, n - 1)
        if has_dead:
            mask = mask & valid[rows]
        x = _dequant(codes[rows], codebooks)             # (b, P * L, d)
        ip = (x * q[lo:hi, None, :]).sum(-1)
        if metric == "inner_product":
            s = -ip
        elif metric == "cosine":
            denom = q_norm[lo:hi, None] \
                * torch.sqrt(torch.clamp(s2[rows], min=0.0))
            s = -(ip / torch.where(denom == 0, 1.0, denom))
        else:
            s = s2[rows] - 2.0 * ip
            if residual:
                off = -2.0 * torch.gather(ip_c[lo:hi], 1, lists[lo:hi])
                s = s + off.repeat_interleave(l_max, dim=1)
        s = torch.where(mask, s, math.inf)
        sv, sel = torch.topk(s, kk, dim=1, largest=False, sorted=True)
        top_s.append(sv)
        top_r.append(torch.where(torch.isinf(sv), -1,
                                 torch.gather(rows, 1, sel)))
    best_s, best_r = torch.cat(top_s), torch.cat(top_r)
    rows_c = torch.clamp(best_r, min=0)
    x = _dequant(codes[rows_c], codebooks)
    if residual:
        x = x + res_cents[row2list[rows_c].long()]
    return exact_rerank_decoded(x, q, q_norm, best_s, best_r, metric, k)
