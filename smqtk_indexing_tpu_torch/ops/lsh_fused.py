"""
Single-call LSH serving: hash -> near-code selection -> bucket expansion
-> exact re-rank on the device, the port of
``smqtk_indexing_tpu/ops/lsh_fused.py``.

The bucket table is device-resident in IVF form: descriptor rows sorted
by bucket, so each unique hash code owns a contiguous row range (off/len
CSR). One eager call of :func:`lsh_fused_query` hashes the queries
(full-f32 product and sign), packs their codes as ``utils/bits`` packs
them, takes the top-n near codes of the unique-code table, expands their
CSR windows, gathers the rows, and re-ranks them exactly. Candidate
semantics are those of the two-call path (n nearest unique codes, the
union of their buckets, exact re-rank): near-ties in code selection may
resolve differently, which the HashIndex contract allows.

The near-code engines (``lsh_fused.py:128-141``):

- ``"xor"``: the streamed XOR-popcount top-n, ``ops/hamming.hamming_topk``;
- ``"mxu"``: the ±1 bf16 code table through ``fused_scan.flat_topk_fused``,
  whose stage 1 is K1's bf16 form (``pallas_scan.segment_minima``; on the
  card ``csrc/segment_minima_wgmma.cu``), exact for ±1 values.

There is no ``interpret`` argument: the tensors' device decides between
the kernel and its plain version.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from smqtk_indexing_tpu_torch.ops import fused_scan
from smqtk_indexing_tpu_torch.ops.device import require_full_f32
from smqtk_indexing_tpu_torch.ops.hamming import DEFAULT_CHUNK, hamming_topk
from smqtk_indexing_tpu_torch.ops.metrics import candidate_distances

#: Cap on the (b, n_codes * l_max, d) f32 candidate block of the re-rank:
#: queries run in blocks under it.
CAND_BYTES = 1 << 28


def pack_bits_device(h: torch.Tensor) -> torch.Tensor:
    """(B, bits) bool -> (B, ceil(bits/32)) int32 words holding the bits
    of ``utils/bits.pack_bit_vectors_u32`` (``np.packbits`` big-endian
    bytes viewed as little-endian uint32 words), so device-packed query
    codes compare with the host-packed unique-code table."""
    b, bits = h.shape
    pad = (-bits) % 32
    if pad:
        h = torch.nn.functional.pad(h, (0, pad))
    hh = h.reshape(b, -1, 4, 8).long()
    shift = torch.arange(7, -1, -1, device=h.device)
    byte_val = (hh << shift).sum(-1)
    word = (byte_val << (8 * torch.arange(4, device=h.device))).sum(-1)
    # The uint32 value as the int32 of the same bits.
    return torch.where(word >= 2 ** 31, word - 2 ** 32, word).int()


def lsh_fused_query(db: torch.Tensor, row_valid: torch.Tensor,
                    packed: torch.Tensor, code_valid: torch.Tensor,
                    off: torch.Tensor, ln: torch.Tensor,
                    q: torch.Tensor, mean: torch.Tensor, proj: torch.Tensor,
                    *, k: int, n_codes: int, n_sel: int, l_max: int,
                    metric: str, normalize=None, engine: str = "xor",
                    pm1: Optional[torch.Tensor] = None,
                    code_sq: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    One-call LSH serve; every tensor on one device.

    :param db: (N_pad, d) float32 descriptor rows SORTED BY BUCKET (each
        unique code's members contiguous).
    :param row_valid: (N_pad,) bool liveness (padding rows False).
    :param packed: (U_pad, W) int32 packed unique hash codes.
    :param code_valid: (U_pad,) bool (padding codes False).
    :param off: (U_pad,) int64 bucket start row per unique code.
    :param ln: (U_pad,) int64 bucket length per unique code.
    :param q: (B, d) float32 queries (pad rows zero; results discarded).
    :param mean: (d,) float32 functor mean (``LshFunctor.hash_model``).
    :param proj: (d, bits) float32 functor projection.
    :param k: top-k results per query.
    :param n_codes: near codes to expand (a power of two).
    :param n_sel: near codes the caller asked for (<= n_codes); the
        selections past it are masked, so the candidates are those of
        ``HashIndex.nn(h, n_sel)``.
    :param l_max: longest bucket (windows pad to it).
    :param metric: 'euclidean' | 'cosine' | 'hik'.
    :param normalize: the functor's row-normalization ``ord`` (None =
        pass-through), applied to HASHING only: the re-rank uses the raw
        query, as the two-call path does.
    :param engine: near-code engine, "xor" or "mxu" (then ``pm1`` and
        ``code_sq`` are required).
    :param pm1: (U_pad, bits_pad) bfloat16 ±1 code rows, zero-padded dims
        and rows ("mxu").
    :param code_sq: (U_pad,) float32 bit count per live code ("mxu").
    :return: (dists (B, k) f32 ascending with +inf pads, rows (B, k) int64
        into the bucket-sorted layout, -1 pads).
    """
    q = q.float()
    require_full_f32(q)
    qh = q
    if normalize is not None:
        nrm = torch.linalg.vector_norm(q, ord=normalize, dim=-1,
                                       keepdim=True)
        qh = q / torch.where(nrm == 0, 1.0, nrm)
    h = (qh - mean[None, :]) @ proj >= 0
    b = q.shape[0]
    if engine == "mxu":
        q_pm1 = torch.zeros((b, pm1.shape[1]), dtype=torch.float32,
                            device=q.device)
        q_pm1[:, :h.shape[1]] = h.float() * 2.0 - 1.0
        _, codes_sel = fused_scan.flat_topk_fused(
            pm1, code_sq, code_valid, q_pm1, k=n_codes)
    elif engine == "xor":
        _, codes_sel = hamming_topk(
            packed, code_valid, pack_bits_device(h), k=n_codes,
            chunk=min(DEFAULT_CHUNK, packed.shape[0]))
    else:
        raise ValueError(f"engine must be 'xor' or 'mxu', not {engine!r}")

    codes_sel = codes_sel.long()
    neg_sel = codes_sel < 0
    codes_sel = torch.clamp(codes_sel, min=0)
    sel_off = off[codes_sel]                            # (B, n_codes)
    # Zero the windows of (a) selections past the requested n_sel codes
    # and (b) dead, padding or -1 selections.
    rank_ok = torch.arange(n_codes, device=q.device)[None, :] < n_sel
    sel_ok = rank_ok & ~neg_sel & code_valid[codes_sel]
    sel_len = torch.where(sel_ok, ln[codes_sel], 0)
    lane = torch.arange(l_max, device=q.device)
    live = lane < sel_len[..., None]                    # (B, n_codes, L)
    rows_flat = torch.where(live, sel_off[..., None] + lane, 0) \
        .reshape(b, n_codes * l_max)
    ok = live.reshape(b, n_codes * l_max) & row_valid[rows_flat]

    m = n_codes * l_max
    kk = min(k, m)
    q_block = max(1, CAND_BYTES // (4 * m * db.shape[1]))
    out_d, out_r = [], []
    for lo in range(0, b, q_block):
        hi = min(lo + q_block, b)
        dist = candidate_distances(q[lo:hi], db[rows_flat[lo:hi]], metric)
        dist = torch.where(ok[lo:hi], dist, math.inf)
        # A stable sort: ties keep the candidates' order, as lax.top_k.
        dd, sel = torch.sort(dist, dim=1, stable=True)
        dd = dd[:, :kk]
        rr = torch.gather(rows_flat[lo:hi], 1, sel[:, :kk])
        out_d.append(dd)
        out_r.append(torch.where(torch.isinf(dd), -1, rr))
    out_d, out_r = torch.cat(out_d), torch.cat(out_r)
    if kk < k:
        out_d = torch.nn.functional.pad(out_d, (0, k - kk), value=math.inf)
        out_r = torch.nn.functional.pad(out_r, (0, k - kk), value=-1)
    return out_d, out_r
