"""
IVF16384 over 100M vectors on one card, in SQ8 and then in residual PQ16:
the port's counterpart of ``examples/ivf_100m.py`` (the reference's FAISS
'IVF16384,SQ8' and 'IVF16384,PQ16' at capacity scale).

    python -m smqtk_indexing_tpu_torch.examples.ivf_100m [--device cuda]

Everything is built on ``device``:

1. k-means trains 16,384 coarse centroids on a 2^20-row sample
   (``ops/kmeans.kmeans_lloyd``, 8 iterations, full-f32 products), the
   corpus's first 2^20 rows.
2. The corpus ingests in chunks of 6,291,456 rows (1,536 tiles of 4,096).
   Each chunk is generated whole on the device, assigned to its nearest
   centroid (full f32), sorted by a stable sort of the assignment, and
   written as (d, 4096) tile-transposed int8 SQ8 codes (``x ~= u / 16``)
   with their row stats straight into one preallocated 12.9 GB buffer.
3. ``build_tiled_csr`` records each (chunk, list) run as sublists cut at
   the window cap and at tile ends; ``build_slot_table`` maps lists to
   their sublists.
4. Held-out queries (fresh mixture draws) get their truth from the
   exhaustive tiled SQ8 scan over the same buffer (``sq8_topk_blocked``:
   K5, then K3; the on-card oracle), then the nprobe sweep (2, 4, 8, 16)
   runs ``ivf_query_dma_tiled_table`` (K7) with ``rerank="score"`` at
   B=128 and B=1,024.
5. The PQ16 phase (``SMQTK_IVF100M_NO_PQ=1`` skips it): the SQ8 buffer is
   freed and the same corpus (the same rows, assignments and CSR) is
   encoded as (n_tiles, 16, 4096) uint8 PQ codes, 1.6 GB at 100M,
   residual by default (codes carry ``x - c[list]``), served by
   ``ivf_query_dma_tiled_table_pq`` (K8). Recall is read against the SQ8
   oracle's truth and against a wide-probe ADC oracle over the same
   codes.

The row recipe: row ``i`` (global id) is ``centers[comp(i)] + SIGMA *
noise``. ``comp(i)`` is the JAX example's Knuth multiplicative hash,
``(i * 2654435761 mod 2^32) mod 16384``; the 16,384 centres are normal
draws of a ``torch.Generator`` seeded 7. The noise of chunk ``c`` comes
from a ``torch.Generator`` seeded ``NOISE_SEED + c``, drawn in
``GEN_ROWS``-row blocks in row order, so the SQ8 pass, the PQ pass and
the assignment-only pass regenerate identical rows, and the training
sample (ids 0 .. 2^20 - 1, contiguous: strided ids alias the hash, see
the JAX example) is a prefix of chunk 0. The JAX example regenerates each
row from a per-row key in sorted order to avoid a 768 MB gather on a 16 GB
chip; an 80 GB card holds a whole chunk (3.2 GB f32) and its sorted copy.

Switches, read at import as the JAX example reads them:
``SMQTK_IVF100M_CHUNKS`` (chunks of 6,291,456 rows; 16 by default),
``SMQTK_IVF100M_MINI`` (every scale knob ~1000x smaller; the device is
still ``--device``), ``SMQTK_IVF100M_NO_SQ8`` (skip the SQ8 phase: list
lengths come from an assignment-only pass; required above 20 chunks),
``SMQTK_IVF100M_NO_PQ``, ``SMQTK_IVF100M_OPQ`` (learn an OPQ rotation on
the residual sample, ``ops/opq.opq_train``) and ``SMQTK_IVF100M_RAW_PQ``
(encode raw rows, not residuals). ``examples/ivf_400m.py`` is the
64-chunk residual-OPQ16 preset.

Each line printed is one JSON object under the JAX example's metric
names (``ivf16384_{LBL}_*``, ``sq8_{LBL}_*``, ``pq16_{LBL}_*``), plus
``device`` (the card's name and power limit, as ``nvidia-smi`` prints
them, or "cpu") and ``peak_device_bytes``.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops.device import (
    require_full_f32, resolve_device,
)
from smqtk_indexing_tpu_torch.ops.ivf_scan import (
    build_slot_table, build_tiled_csr, ivf_query_dma_tiled_table,
    ivf_query_dma_tiled_table_pq,
)
from smqtk_indexing_tpu_torch.ops.kmeans import kmeans_assign, kmeans_lloyd
from smqtk_indexing_tpu_torch.ops.opq import opq_train
from smqtk_indexing_tpu_torch.ops.sq8 import sq8_topk_blocked

#: ``SMQTK_IVF100M_MINI=1`` shrinks every scale knob ~1000x.
MINI = bool(os.environ.get("SMQTK_IVF100M_MINI"))

D = 128
TILE = 4096
#: Chunks of ~6.29M rows: 16 -> 100.7M (SQ8 and PQ), 64 -> 402.7M (PQ
#: only: SQ8 needs N bytes of device memory, so ``SMQTK_IVF100M_NO_SQ8=1``
#: must accompany more than 20 chunks).
N_CHUNKS = int(os.environ.get("SMQTK_IVF100M_CHUNKS", "4" if MINI
                              else "16"))
TILES_PER_CHUNK = 4 if MINI else 1536
CHUNK = TILES_PER_CHUNK * TILE           # 6,291,456 at full scale
N = N_CHUNKS * CHUNK                     # 100,663,296 at 16 chunks
#: Skip the SQ8 phase (the exhaustive oracle and the IVF-SQ8 sweep).
SKIP_SQ8 = bool(os.environ.get("SMQTK_IVF100M_NO_SQ8"))
C_LISTS = 64 if MINI else 16384
#: Label of the metric names ("100m", "403m", ...).
LBL = f"{round(N / 1e6)}m" if not MINI else "mini"
L_GEN = C_LISTS                          # generation mixture components
SIGMA = 0.25
A_SCALE = 1.0 / 16.0                     # codec: x ~= a * u, b = 0
TRAIN_ROWS = (1 << 14) if MINI else (1 << 20)
KM_ITERS = 4 if MINI else 8
B = 32 if MINI else 128                  # query batch, with truth
B_LARGE = 8 * B                          # the large batch, timed only
K = 16
#: Rows a noise draw: CHUNK and TRAIN_ROWS are multiples of it.
GEN_ROWS = min(1 << 18, CHUNK, TRAIN_ROWS)
#: Seed of the centres' generator, and of chunk c's noise (+ c).
CENTER_SEED = 7
NOISE_SEED = 42 << 20
#: Sorted rows encoded at a time: SQ8 (64 tiles), and PQ, whose (rows,
#: 16, 256) f32 distances stay at 1 GB.
ENCODE_ROWS = 1 << 18
PQ_ENCODE_ROWS = 1 << 16

M_PQ = 16                                # PQ subquantizers
DSUB = D // M_PQ                         # 8 dims a subspace
PQ_PHASE = not bool(os.environ.get("SMQTK_IVF100M_NO_PQ"))
#: Residual encoding (FAISS by_residual), the default as in JAX;
#: ``SMQTK_IVF100M_RAW_PQ=1`` encodes raw rows.
RESIDUAL_PQ = not bool(os.environ.get("SMQTK_IVF100M_RAW_PQ"))
#: ``SMQTK_IVF100M_OPQ=1``: an OPQ rotation on the (residual) sample.
OPQ_ROT = os.environ.get("SMQTK_IVF100M_OPQ", "") not in ("", "0")
#: Timed repetitions of each query batch.
REPS = 3


def components(ids: torch.Tensor) -> torch.Tensor:
    """Mixture component of each global row id: the JAX example's Knuth
    multiplicative hash, in uint32 arithmetic (``ivf_100m.py:128-129``)."""
    return ((ids.long() * 2654435761) & 0xFFFFFFFF) % L_GEN


def make_centers(device) -> torch.Tensor:
    """The (L_GEN, D) mixture centres."""
    g = torch.Generator(device=device).manual_seed(CENTER_SEED)
    return torch.randn((L_GEN, D), generator=g, device=device)


def chunk_rows(centers: torch.Tensor, ci: int, n_rows: int = CHUNK
               ) -> torch.Tensor:
    """The first ``n_rows`` rows of chunk ``ci`` (a multiple of
    GEN_ROWS), (n_rows, D) float32 on the centres' device, in row order."""
    dev = centers.device
    g = torch.Generator(device=dev).manual_seed(NOISE_SEED + ci)
    out = torch.empty((n_rows, D), dtype=torch.float32, device=dev)
    base = ci * CHUNK
    for lo in range(0, n_rows, GEN_ROWS):
        ids = torch.arange(base + lo, base + lo + GEN_ROWS, device=dev)
        noise = torch.randn((GEN_ROWS, D), generator=g, device=dev)
        out[lo:lo + GEN_ROWS] = centers[components(ids)] + noise * SIGMA
    return out


def assign_order(cents: torch.Tensor, rows: torch.Tensor):
    """Full-f32 assignment of one chunk's rows, the stable sort order by
    list, and the per-list row counts (``ivf_100m.py:184-205``): (order,
    assignments, lens (C_LISTS,) int64)."""
    asg = kmeans_assign(rows, cents)
    order = torch.argsort(asg, stable=True)
    lens = torch.bincount(asg, minlength=C_LISTS)
    return order, asg, lens


def sq8_tiles(rows_sorted: torch.Tensor):
    """(tiles (T, D, TILE) int8, s2 (T, 1, TILE) f32) of sorted rows: the
    SQ8 codes ``clip(rint(x / A_SCALE), -127, 127)`` tile-transposed, and
    ``sum((A_SCALE u)^2)`` a row."""
    u = torch.clamp(torch.round(rows_sorted / A_SCALE), -127, 127)
    s2 = ((A_SCALE * u) ** 2).sum(-1)
    t = u.shape[0] // TILE
    return (u.to(torch.int8).reshape(t, TILE, D).transpose(1, 2)
            .contiguous(), s2.reshape(t, 1, TILE))


def pq_tiles(rows_sorted, asg_sorted, cents, cb, rot=None):
    """(codes (T, M_PQ, TILE) uint8, s2 (T, 1, TILE) f32) of sorted rows
    (``ivf_100m.py:208-264``): residual rows ``x - c[list]`` (raw rows
    under ``SMQTK_IVF100M_RAW_PQ``), rotated by ``rot`` when given,
    encoded by their nearest codeword a subspace in full f32; ``s2`` is
    the squared norm of the reconstruction in codec space (``c @ R +
    r_hat``, or the raw reconstruction)."""
    require_full_f32(rows_sorted)
    cb_sq = (cb * cb).sum(-1)                            # (M, 256)
    codes_out, s2_out = [], []
    for lo in range(0, rows_sorted.shape[0], PQ_ENCODE_ROWS):
        x = rows_sorted[lo:lo + PQ_ENCODE_ROWS]
        c_rows = cents[asg_sorted[lo:lo + PQ_ENCODE_ROWS]] if RESIDUAL_PQ \
            else None
        enc = x - c_rows if RESIDUAL_PQ else x
        if rot is not None:
            enc = enc @ rot
        rs = enc.reshape(-1, M_PQ, DSUB)
        d2 = cb_sq[None] - 2.0 * torch.einsum("tms,mvs->tmv", rs, cb)
        codes = torch.argmin(d2, dim=2)                  # (T, M)
        rhat = cb[torch.arange(M_PQ, device=x.device)[None, :], codes] \
            .reshape(-1, D)
        if RESIDUAL_PQ:
            xhat = (c_rows if rot is None else c_rows @ rot) + rhat
        else:
            xhat = rhat
        s2_out.append((xhat * xhat).sum(-1))
        codes_out.append(codes.to(torch.uint8))
    codes = torch.cat(codes_out)
    t = codes.shape[0] // TILE
    return (codes.reshape(t, TILE, M_PQ).transpose(1, 2).contiguous(),
            torch.cat(s2_out).reshape(t, 1, TILE))


def card_name(dev: torch.device) -> str:
    """The card's name and power limit as ``nvidia-smi`` prints them, or
    "cpu"."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def recall_at_10(got: np.ndarray, truth: np.ndarray) -> float:
    """Mean overlap of each query's first ten rows with its truth's."""
    return float(np.mean([len(set(g.tolist()) & set(t.tolist())) / 10.0
                          for g, t in zip(got[:, :10], truth[:, :10])]))


def main(device="cuda", hooks=None) -> list:
    """
    Run the example on ``device``; returns the records printed.

    :param hooks: optional ``{"sq8": f, "pq": g}``: each is called once
        with a dict of its phase's resident operands after that phase's
        sweep (a caller holding the kernels on them, as ``chip_smoke.py``
        does).

    :raises ValueError: SQ8 above 20 chunks without
        ``SMQTK_IVF100M_NO_SQ8`` (the JAX example's assert).
    :raises RuntimeError: ``device`` is a CUDA device and no card is
        present.
    """
    if not SKIP_SQ8 and N_CHUNKS > 20:
        raise ValueError(
            "SQ8 needs N bytes of device memory: set SMQTK_IVF100M_NO_SQ8=1 "
            "above ~20 chunks (the PQ capacity tier is the point at that "
            "scale)")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    if cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    card = card_name(dev)
    records = []

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    def emit(**kw):
        kw["device"] = card
        kw["peak_device_bytes"] = torch.cuda.max_memory_allocated(dev) \
            if cuda else None
        records.append(kw)
        print(json.dumps(kw), flush=True)

    def timed(run):
        """(result, cold seconds, mean seconds of REPS warm calls)."""
        t0 = time.perf_counter()
        out = run()
        sync()
        cold = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(REPS):
            out = run()
        sync()
        return out, cold, (time.perf_counter() - t0) / REPS

    centers = make_centers(dev)
    t0 = time.perf_counter()
    sample = chunk_rows(centers, 0, TRAIN_ROWS)
    cents, _ = kmeans_lloyd(sample, torch.ones(TRAIN_ROWS, dtype=torch.bool,
                                               device=dev),
                            sample[:C_LISTS], n_iter=KM_ITERS)
    sync()
    del sample
    emit(metric=f"ivf16384_{LBL}_kmeans_train_wall",
         value=time.perf_counter() - t0, unit="s", train_rows=TRAIN_ROWS,
         n_lists=C_LISTS)

    t0 = time.perf_counter()
    chunk_lens = np.zeros((N_CHUNKS, C_LISTS), np.int64)
    n_tiles = N_CHUNKS * TILES_PER_CHUNK
    big = s2big = None
    if SKIP_SQ8:
        for ci in range(N_CHUNKS):
            rows = chunk_rows(centers, ci)
            chunk_lens[ci] = assign_order(cents, rows)[2].cpu().numpy()
            del rows
        emit(metric=f"ivf16384_{LBL}_assign_pass_wall",
             value=time.perf_counter() - t0, unit="s", rows=N)
    else:
        big = torch.empty((n_tiles, D, TILE), dtype=torch.int8, device=dev)
        s2big = torch.empty((n_tiles, 1, TILE), dtype=torch.float32,
                            device=dev)
        for ci in range(N_CHUNKS):
            rows = chunk_rows(centers, ci)
            order, _, lens = assign_order(cents, rows)
            chunk_lens[ci] = lens.cpu().numpy()
            t_lo = ci * TILES_PER_CHUNK
            for lo in range(0, CHUNK, ENCODE_ROWS):
                tiles, s2 = sq8_tiles(rows[order[lo:lo + ENCODE_ROWS]])
                t_at = t_lo + lo // TILE
                big[t_at:t_at + tiles.shape[0]] = tiles
                s2big[t_at:t_at + tiles.shape[0]] = s2
            del rows, order
        sync()
        emit(metric=f"ivf16384_{LBL}_build_wall",
             value=time.perf_counter() - t0, unit="s", rows=N,
             device_gb=(N * D + N * 4) / 2 ** 30)
    assert chunk_lens.sum() == N

    chunk_bases = np.arange(N_CHUNKS, dtype=np.int64) * CHUNK
    v_tile, v_col, v_len, v_orig, _ = build_tiled_csr(chunk_lens,
                                                      chunk_bases)
    table = build_slot_table(v_orig, C_LISTS)
    emit(metric=f"ivf16384_{LBL}_layout", value=len(v_len),
         unit="sublists", s_max=int(table.shape[1]),
         mean_sublist_rows=float(v_len.mean()),
         max_list_rows=int(chunk_lens.sum(0).max()))
    layout = tuple(torch.from_numpy(np.ascontiguousarray(x)).to(dev)
                   for x in (table, v_tile, v_col, v_len))

    # Held-out queries: fresh mixture draws, never inserted. B carry
    # truth; B_LARGE time the large batch.
    b_large = B_LARGE
    rng = np.random.default_rng(123)
    centers_np = centers.cpu().numpy()
    q_np = (centers_np[rng.integers(0, L_GEN, b_large)]
            + rng.normal(size=(b_large, D)) * SIGMA).astype(np.float32)
    qd = torch.from_numpy(q_np[:B]).to(dev)
    qd_large = torch.from_numpy(q_np).to(dev)
    a_vec = torch.full((D,), A_SCALE, dtype=torch.float32, device=dev)
    b_vec = torch.zeros((D,), dtype=torch.float32, device=dev)

    truth = None
    exh_qps = None
    if not SKIP_SQ8:
        s2_rows = s2big.reshape(N)
        valid = torch.ones((N,), dtype=torch.bool, device=dev)
        (_, rr_o), cold, exh_dt = timed(lambda: sq8_topk_blocked(
            big, a_vec, b_vec, s2_rows, valid, qd, k=K))
        truth = rr_o.cpu().numpy()[:, :10]
        exh_qps = B / exh_dt
        emit(metric=f"sq8_{LBL}_exhaustive_scan_b128", value=exh_qps,
             unit="queries/s", batch_ms=exh_dt * 1e3,
             cold_incl_compile_s=cold)
        del valid, rr_o

    # The nprobe sweep stops at 16 (recall is 1.0 from nprobe 4 on this
    # mixture, docs/benchmarks.md Config 5b).
    for nprobe in () if SKIP_SQ8 else (2, 4, 8, 16):
        def run(q, nprobe=nprobe):
            return ivf_query_dma_tiled_table(
                big, s2big, a_vec, b_vec, cents, *layout, q, k=K,
                nprobe_orig=nprobe, rerank="score")
        (_, rr), cold, dt = timed(lambda: run(qd))
        rec = recall_at_10(rr.cpu().numpy(), truth)
        _, _, dt_l = timed(lambda: run(qd_large))
        emit(metric=f"ivf16384_sq8_{LBL}_nprobe{nprobe}", value=B / dt,
             unit="queries/s", recall_at_10=rec, batch_ms=dt * 1e3,
             qps_b1024=b_large / dt_l, batch_ms_b1024=dt_l * 1e3,
             speedup_vs_exhaustive_b1024=(b_large / dt_l) / exh_qps,
             speedup_vs_exhaustive=(B / dt) / exh_qps,
             cold_incl_compile_s=cold)

    hooks = hooks or {}
    if "sq8" in hooks and not SKIP_SQ8:
        hooks["sq8"](dict(codes=big, s2t=s2big, a=a_vec, b=b_vec,
                          centroids=cents, layout=layout, q=qd,
                          q_large=qd_large, k=K))
    if not PQ_PHASE:
        return records

    # ---- PQ16: N vectors in N * 16 bytes ------------------------------
    # The SQ8 buffer goes first; the CSR and the slot table stay valid
    # (the same rows and assignments).
    big = s2big = s2_rows = None
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sample = chunk_rows(centers, 0, TRAIN_ROWS)
    if RESIDUAL_PQ:
        # Codebooks train on residuals, the distribution the codes carry.
        sample = sample - cents[kmeans_assign(sample, cents)]
    rot = None
    if OPQ_ROT:
        rot_np, cb_np = opq_train(sample.cpu().numpy(), M_PQ, device=dev)
        rot = torch.from_numpy(rot_np).to(dev)
        cb = torch.from_numpy(cb_np).to(dev)
    else:
        ones = torch.ones(TRAIN_ROWS, dtype=torch.bool, device=dev)
        cb = torch.stack([
            kmeans_lloyd(sub, ones, sub[:256], n_iter=KM_ITERS)[0]
            for sub in (sample[:, m * DSUB:(m + 1) * DSUB].contiguous()
                        for m in range(M_PQ))])      # (M, 256, DSUB)
    sync()
    del sample
    emit(metric=f"pq16_{LBL}_train_wall", value=time.perf_counter() - t0,
         unit="s", subspaces=M_PQ, dsub=DSUB, residual=RESIDUAL_PQ,
         opq=OPQ_ROT)

    t0 = time.perf_counter()
    bigp = torch.empty((n_tiles, M_PQ, TILE), dtype=torch.uint8, device=dev)
    s2bigp = torch.empty((n_tiles, 1, TILE), dtype=torch.float32,
                         device=dev)
    for ci in range(N_CHUNKS):
        rows = chunk_rows(centers, ci)
        order, asg, _ = assign_order(cents, rows)
        rows = rows[order]
        asg = asg[order]
        del order
        codes, s2 = pq_tiles(rows, asg, cents, cb, rot)
        bigp[ci * TILES_PER_CHUNK:(ci + 1) * TILES_PER_CHUNK] = codes
        s2bigp[ci * TILES_PER_CHUNK:(ci + 1) * TILES_PER_CHUNK] = s2
        del rows, asg, codes, s2
    sync()
    emit(metric=f"pq16_{LBL}_build_wall", value=time.perf_counter() - t0,
         unit="s", rows=N, device_gb=(N * M_PQ + N * 4) / 2 ** 30)

    # The codec's transform: the identity interleave, or the rotation
    # (queries and probe centroids transform inside the query); residual
    # mode takes the codec-space centroids.
    perm = rot if rot is not None else torch.arange(D, device=dev)
    res_c = (cents if rot is None else cents @ rot) if RESIDUAL_PQ \
        else None

    def run_pq(q, nprobe):
        return ivf_query_dma_tiled_table_pq(
            bigp, s2bigp, cb, perm, cents, *layout, q, k=K,
            nprobe_orig=nprobe, rerank="score", res_cents=res_c)

    # ADC oracle: a wide probe over the same codes separates the lists'
    # coverage loss from the codec's; its slot budget is capped near 2,048
    # slots as in the JAX example.
    oracle_np = min(64, max(1, 2048 // int(table.shape[1])))
    truth_adc = run_pq(qd, oracle_np)[1].cpu().numpy()[:, :10]
    for nprobe in (2, 4, 8, 16):
        (_, rr), cold, dt = timed(lambda: run_pq(qd, nprobe))
        got = rr.cpu().numpy()
        _, _, dt_l = timed(lambda: run_pq(qd_large, nprobe))
        emit(metric=f"ivf16384_pq16_{LBL}_nprobe{nprobe}", value=B / dt,
             unit="queries/s", residual=RESIDUAL_PQ, opq=OPQ_ROT, rows=N,
             recall_at_10_vs_float_oracle=(
                 None if truth is None else recall_at_10(got, truth)),
             recall_at_10_vs_adc_oracle=recall_at_10(got, truth_adc),
             adc_oracle_nprobe=oracle_np, batch_ms=dt * 1e3,
             qps_b1024=b_large / dt_l, batch_ms_b1024=dt_l * 1e3,
             cold_incl_compile_s=cold)
    if "pq" in hooks:
        hooks["pq"](dict(codes=bigp, s2t=s2bigp, codebooks=cb,
                         transform=perm, centroids=cents, layout=layout,
                         q=qd, q_large=qd_large, k=K, res_cents=res_c))
    return records


def check_recall(records: list, floor: float = 0.99) -> None:
    """Raise unless every SQ8 line's recall@10 against the exhaustive
    oracle and every PQ line's against the ADC oracle is at least
    ``floor`` (``docs/benchmarks.md`` Configs 5b / 5c: 1.000)."""
    low = [(r["metric"], r.get("recall_at_10",
                               r.get("recall_at_10_vs_adc_oracle")))
           for r in records if "_nprobe" in r["metric"]]
    low = [(m, v) for m, v in low if v < floor]
    if low:
        raise AssertionError(f"recall@10 under {floor}: {low}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda")
    check_recall(main(parser.parse_args().device))
