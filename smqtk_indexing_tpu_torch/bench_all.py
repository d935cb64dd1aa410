"""
The port's full benchmark table: the counterpart of the repository's
``bench_all.py``, section for section, at its sizes. One JSON line a
measurement; each line carries the keys of the JAX line it stands beside,
and its ``metric`` is the JAX name with the prefix ``torch_``, so the two
never mix in a record.

    python -m smqtk_indexing_tpu_torch.bench_all [section ...] [--device cpu]

Sections (``bench_all.py:507-540``): ``itq``, ``lsh_e2e``, ``ivf`` (tags
``""``, ``_sq8``, ``_pq16``), ``mrpt``, ``sq8``, ``ivf_code``,
``ivf_code_pq`` and, only when named, ``ivf_corr``. No section named
runs every section but ``ivf_corr``. Everything runs on the card unless
``--device cpu`` is given; a section's sizes are parameters of its
function, so a test can run it small.

Methodology (``bench_all.py:1-27``): queries are held out (drawn from the
database's distribution and never inserted, or the TexMex ``*_query``
file), and ground truth is the chunked float64 exact scan. The data is
synthetic at the published shapes unless ``$SMQTK_TPU_DATA`` holds the
TexMex ``.fvecs`` files (the ``dataset`` key says which was used); the
recipes are copied here from ``bench_all.py``, so the port reads nothing
of the JAX side.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

#: Held-out queries of the recall measurements.
N_QUERIES = 128

#: Prefix of every emitted ``metric`` (the JAX line's name follows it).
PREFIX = "torch_"

#: Rows of one chunk of the clustered recipe's noise: the same numbers as
#: one draw, without a float64 copy of the whole matrix.
_NOISE_ROWS = 1 << 16


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def _load_or_make(name: str, n: int, d: int, scale: float, seed: int,
                  nq: int = N_QUERIES, rank: int = None):
    """
    ``bench_all._load_or_make`` (``bench_all.py:44-93``), byte for byte.

    :return: (db (n, d) float32, queries (nq, d) float32, dataset label).
        Queries are held out: the TexMex query file when available, else
        fresh draws from the same synthetic mixture (never indexed).
    """
    data_dir = os.environ.get("SMQTK_TPU_DATA", "")
    path = os.path.join(data_dir, name) if data_dir else ""
    # A rank-controlled section measures a specific synthetic regime; a
    # real corpus must not stand in for it under the same metric name.
    if path and os.path.isfile(path) and rank is None:
        from smqtk_indexing_tpu_torch import native
        db = native.read_vecs(path, n, d)
        qpath = path.replace("_base.", "_query.").replace("base.", "query.")
        if os.path.isfile(qpath) and qpath != path:
            q = native.read_vecs(qpath, nq, d)
        else:  # hold out the tail of the base file
            q, db = db[-nq:], db[:-nq]
        return db, q[:nq], name
    rng = np.random.default_rng(seed)
    n_clusters = 1024
    total = n + nq
    if rank is not None:
        # Correlated flavour: the mixture lives in a rank-`rank` latent
        # subspace mixed through a random linear map.
        lat = rng.random((n_clusters, rank), dtype=np.float32) * scale
        w = rng.standard_normal((rank, d)).astype(np.float32) \
            / np.sqrt(rank)
        z = lat[rng.integers(0, n_clusters, size=total)]
        z += rng.normal(size=(total, rank)).astype(np.float32) \
            * (scale / 12)
        pts = (z @ w + rng.normal(size=(total, d)).astype(np.float32)
               * (scale / 50)).astype(np.float32)
        pts = pts[rng.permutation(total)]
        return pts[:n], pts[n:], f"synthetic-rank{rank}"
    # Clustered mixture; queries are independent draws from it.
    centers = rng.random((n_clusters, d), dtype=np.float32) * scale
    pts = centers[rng.integers(0, n_clusters, size=total)]
    for lo in range(0, total, _NOISE_ROWS):
        hi = min(lo + _NOISE_ROWS, total)
        pts[lo:hi] += rng.normal(size=(hi - lo, d)).astype(np.float32) \
            * (scale / 12)
    np.clip(pts, 0, scale, out=pts)
    pts = pts[rng.permutation(total)]
    return pts[:n], pts[n:], "synthetic"


def _recall_at_10(got_ids, true_ids) -> float:
    return float(np.mean([
        len(set(g[:10]) & set(t[:10])) / 10.0
        for g, t in zip(got_ids, true_ids)]))


def _exact_ground_truth(db, queries, k=10, chunk=100_000):
    """Chunked float64 exact top-k on the host (``bench_all.py:102-119``)."""
    q64 = queries.astype(np.float64)
    q_sq = (q64 ** 2).sum(1)[:, None]
    best = None
    for lo in range(0, db.shape[0], chunk):
        x = db[lo:lo + chunk].astype(np.float64)
        d2 = q_sq + (x ** 2).sum(1)[None, :] - 2.0 * (q64 @ x.T)
        ids = np.argsort(d2, axis=1)[:, :k] + lo
        vals = np.take_along_axis(d2, ids - lo, axis=1)
        if best is None:
            best = (vals, ids)
        else:
            cv = np.concatenate([best[0], vals], axis=1)
            ci = np.concatenate([best[1], ids], axis=1)
            sel = np.argsort(cv, axis=1)[:, :k]
            best = (np.take_along_axis(cv, sel, axis=1),
                    np.take_along_axis(ci, sel, axis=1))
    return best[1]


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def _env(values: dict):
    """Set environment variables for the block, then restore them."""
    saved = {k: os.environ.get(k) for k in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _elements(mat: np.ndarray, prefix=None):
    from smqtk_indexing_tpu_torch.data.descriptor import (
        DescriptorMemoryElement,
    )
    return [DescriptorMemoryElement(i if prefix is None else f"{prefix}{i}",
                                    mat[i]) for i in range(mat.shape[0])]


def bench_itq_linear(device: str = "cuda", n: int = 1_000_000,
                     fit_rows: int = 100_000, b: int = 1024,
                     pools=(64, 256, 512, 2048)) -> None:
    """ITQ-128 fit, batched hashing and the two Hamming engines over the
    codes (``bench_all.py:122-240``): K1's bf16 form over the ±1 codes
    (``fused_scan.flat_topk_fused``) and the XOR route
    (``ops/hamming.hamming_topk``), then hash-then-rerank recall@10 over
    candidate pools."""
    from smqtk_indexing_tpu_torch.ops.device import (
        pow2_at_least, resolve_device,
    )
    from smqtk_indexing_tpu_torch.ops.fused_scan import flat_topk_fused
    from smqtk_indexing_tpu_torch.ops.hamming import (
        hamming_topk, words_to_tensor,
    )
    from smqtk_indexing_tpu_torch.ops.itq import hash_batch, itq_fit
    from smqtk_indexing_tpu_torch.utils.bits import pack_bit_vectors_u32

    dev = resolve_device(device)
    d, bits = 128, 128
    db, queries, dataset = _load_or_make("sift_base.fvecs", n, d, 218.0,
                                         seed=0)
    n = db.shape[0]
    fit_sample = db[np.random.default_rng(0).choice(n, min(fit_rows, n),
                                                    replace=False)]
    r_init = np.random.default_rng(0).standard_normal(
        (bits, bits)).astype(np.float32)
    x_fit = torch.from_numpy(fit_sample).to(dev)
    r0 = torch.from_numpy(r_init).to(dev)
    t0 = time.perf_counter()
    mean_vec, rotation = itq_fit(x_fit, r0, bits=bits, n_iter=50)
    _sync(dev)
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mean_vec, rotation = itq_fit(x_fit, r0, bits=bits, n_iter=50)
    _sync(dev)
    fit_s = time.perf_counter() - t0
    emit(metric=f"{PREFIX}itq128_fit_100k_wall", value=round(fit_s, 2),
         unit="s", cold_incl_compile_s=round(cold_s, 2), dataset=dataset,
         note="target < 60s (BASELINE.md)")

    dev_db = torch.from_numpy(db).to(dev)
    codes = hash_batch(dev_db, mean_vec, rotation).cpu().numpy()
    t0 = time.perf_counter()
    codes = hash_batch(dev_db, mean_vec, rotation).cpu().numpy()
    hash_s = time.perf_counter() - t0
    del dev_db
    emit(metric=f"{PREFIX}itq128_hash_1m_throughput",
         value=round(n / hash_s, 0), unit="vectors/s", dataset=dataset)

    # The ±1 engine: d^2 between ±1 vectors is 4 x Hamming, exactly.
    n_pad = pow2_at_least(n, lo=1024)
    b = min(b, n)
    pm1 = np.zeros((n_pad, bits), dtype=np.float32)
    pm1[:n] = codes * 2.0 - 1.0
    sqv = np.zeros(n_pad, dtype=np.float32)
    sqv[:n] = float(bits)
    valid = np.zeros(n_pad, dtype=bool)
    valid[:n] = True
    dev_pm1 = torch.from_numpy(pm1).to(dev, torch.bfloat16)
    dev_sqv = torch.from_numpy(sqv).to(dev)
    dev_valid = torch.from_numpy(valid).to(dev)
    q_pm1 = torch.from_numpy(pm1[:b]).to(dev)

    def mxu(qv, k):
        dd, rr = flat_topk_fused(dev_pm1, dev_sqv, dev_valid, qv, k=k)
        return dd.cpu().numpy(), rr.cpu().numpy()

    dd, _ = mxu(q_pm1, 16)
    lat = []
    for _ in range(5):
        t0 = time.perf_counter()
        dd, _ = mxu(q_pm1, 16)
        lat.append(time.perf_counter() - t0)
    p50 = sorted(lat)[len(lat) // 2]
    emit(metric=f"{PREFIX}hamming128_1m_lookup_p50_b1024",
         value=round(p50 * 1e3, 2), unit="ms", qps=round(b / p50, 0),
         engine="mxu_pm1", dataset=dataset)
    # Each query is a stored code: its nearest code is at distance 0 (a
    # duplicate code may take the first place).
    if not (dd[:, 0] == 0.0).all():
        raise RuntimeError("hamming: a stored code did not find itself")

    packed = pack_bit_vectors_u32(codes)
    packed_p = np.zeros((n_pad, packed.shape[1]), dtype=np.uint32)
    packed_p[:n] = packed
    dev_packed = words_to_tensor(packed_p, dev)
    qcodes = words_to_tensor(packed[:b], dev)
    hamming_topk(dev_packed, dev_valid, qcodes, k=16)
    _sync(dev)
    t0 = time.perf_counter()
    dd2, _ = hamming_topk(dev_packed, dev_valid, qcodes, k=16)
    dd2 = dd2.cpu().numpy()
    xor_ms = (time.perf_counter() - t0) * 1e3
    emit(metric=f"{PREFIX}hamming128_1m_lookup_xor_engine_b1024",
         value=round(xor_ms, 2), unit="ms", qps=round(b / xor_ms * 1e3, 0),
         dataset=dataset)
    if not np.array_equal(dd2, np.round(dd.astype(np.float64) ** 2 / 4.0)
                          .astype(np.int32)):
        raise RuntimeError("hamming: the ±1 and XOR engines disagree")
    del dev_packed, qcodes

    nq = queries.shape[0]
    truth = _exact_ground_truth(db, queries)
    q_codes = hash_batch(torch.from_numpy(queries).to(dev), mean_vec,
                         rotation).cpu().numpy()
    q_pm1_r = torch.from_numpy((q_codes * 2.0 - 1.0).astype(np.float32)) \
        .to(dev)
    for pool in pools:
        mxu(q_pm1_r, pool)
        t0 = time.perf_counter()
        _, cand = mxu(q_pm1_r, pool)
        ham_s = time.perf_counter() - t0
        got = []
        for qi in range(nq):
            c = cand[qi][cand[qi] >= 0]
            dist = ((db[c] - queries[qi]) ** 2).sum(1)
            got.append(c[np.argsort(dist)][:10])
        emit(metric=f"{PREFIX}itq128_hamming_rerank_pool{pool}_recall_at_10",
             value=round(_recall_at_10(got, truth), 4), unit="recall",
             hamming_qps=round(nq / ham_s, 0), dataset=dataset,
             note="held-out queries; exact re-rank of the pool")


#: bench_ivf variant tags -> (dtype, storage, rerank, build_env[, extra
#: constructor arguments]) (``bench_all.py:243-285``). build_env pins
#: routing decisions made at build time, so A/B columns stay stable.
_IVF_VARIANTS = {
    "": ("float32", "rows", "exact", {}),
    "_sq8": ("sq8", "rows", "exact", {}),
    "_sq8_score": ("sq8", "rows", "score", {}),
    "_sq8_rowmajor": ("sq8", "rows", "exact",
                      {"SMQTK_TPU_NO_ROWS_TILED": "1"}),
    "_pq16": ("pq16", "rows", "exact", {}),
    "_pq16_rowmajor": ("pq16", "rows", "exact",
                       {"SMQTK_TPU_NO_ROWS_TILED": "1"}),
    "_code": ("sq8", "code", "exact", {}),
    "_code_score": ("sq8", "code", "score", {}),
    "_code_pq16": ("pq16", "code", "exact", {}),
    "_code_pq16_score": ("pq16", "code", "score", {}),
    "_opq16": ("opq16", "rows", "exact", {}),
    "_code_opq16_score": ("opq16", "code", "score", {}),
    "_pq16_res": ("pq16", "rows", "exact", {}, {"pq_residual": True}),
    "_code_pq16_res_score": ("pq16", "code", "score", {},
                             {"pq_residual": True}),
    "_opq16_res": ("opq16", "rows", "exact", {}, {"pq_residual": True}),
}


def bench_ivf(tags=("", "_sq8", "_pq16"),
              nprobes=(1, 2, 4, 8, 16, 32, 64, 128),
              rank=None, label="deep1m", device: str = "cuda",
              n: int = 1_000_000, n_lists: int = 4096, nq_large: int = 1024
              ) -> None:
    """IVF4096 nprobe sweeps over the storage codecs
    (``bench_all.py:288-352``): recall@10 on 128 held-out queries against
    float64, and queries/s at B=128 and B=1024 through ``nn_many``."""
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )

    d = 96
    db, queries, dataset = _load_or_make("deep_base.fvecs", n, d, 1.0,
                                         seed=2, nq=nq_large, rank=rank)
    n = db.shape[0]
    elems = _elements(db)
    nq_r = min(N_QUERIES, queries.shape[0])
    truth = _exact_ground_truth(db, queries[:nq_r])
    q_recall = _elements(queries[:nq_r], "q")
    q_large = _elements(queries, "Q")
    for tag in tags:
        dtype, storage, rerank, build_env, *rest = _IVF_VARIANTS[tag]
        idx = IvfNearestNeighborsIndex(
            n_lists=n_lists, kmeans_iterations=10,
            max_points_per_centroid=64, random_seed=0, dtype=dtype,
            storage=storage, rerank=rerank, device=device,
            **(rest[0] if rest else {}))
        t0 = time.perf_counter()
        with _env(build_env):
            idx.build_index(elems)
        emit(metric=f"{PREFIX}ivf4096{tag}_{label}_build_wall",
             value=round(time.perf_counter() - t0, 1), unit="s",
             dataset=dataset)
        for nprobe in nprobes:
            idx.nprobe = nprobe
            res = idx.nn_many(q_recall, 10)          # warm
            t0 = time.perf_counter()
            for _ in range(3):
                res = idx.nn_many(q_recall, 10)
            dt128 = (time.perf_counter() - t0) / 3
            got = [[e.uuid() for e in r] for r, _ in res]
            idx.nn_many(q_large, 10)                 # warm
            t0 = time.perf_counter()
            for _ in range(2):
                idx.nn_many(q_large, 10)
            dt_large = (time.perf_counter() - t0) / 2
            emit(metric=f"{PREFIX}ivf4096{tag}_{label}_nprobe{nprobe}",
                 value=round(nq_r / dt128, 0), unit="queries/s",
                 qps_b1024=round(len(q_large) / dt_large, 0),
                 dataset=dataset,
                 recall_at_10=round(_recall_at_10(got, truth), 4))
        del idx


def bench_lsh_e2e(device: str = "cuda", n: int = 1_000_000,
                  nq_large: int = 1024, fit_rows: int = 100_000) -> None:
    """LSH serving through the public API (``bench_all.py:355-421``):
    ITQ-128, hash buckets and the exact re-rank at B=128 and B=1024, the
    fused serve beside the two-call path (``SMQTK_TPU_NO_LSH_FUSED``) in
    the same process."""
    from smqtk_indexing_tpu_torch.models.lsh_functor.itq import ItqFunctor
    from smqtk_indexing_tpu_torch.models.nn_index.lsh import (
        LSHNearestNeighborIndex,
    )

    d = 128
    db, queries, dataset = _load_or_make("sift_base.fvecs", n, d, 218.0,
                                         seed=0, nq=nq_large)
    n = db.shape[0]
    nq_r = min(N_QUERIES, queries.shape[0])
    truth = _exact_ground_truth(db, queries[:nq_r])
    els = _elements(db)
    q128 = _elements(queries[:nq_r], "q")
    q_large = _elements(queries, "Q")

    functor = ItqFunctor(bit_length=128, random_seed=0, device=device)
    functor.fit(els[:fit_rows])
    idx = LSHNearestNeighborIndex(lsh_functor=functor,
                                  distance_method="euclidean",
                                  device=device)
    t0 = time.perf_counter()
    idx.build_index(els)
    emit(metric=f"{PREFIX}lsh_e2e_itq128_build_wall",
         value=round(time.perf_counter() - t0, 1), unit="s",
         dataset=dataset)
    st = idx._fused_ready(10, len(q_large))
    fused = idx._fused
    emit(metric=f"{PREFIX}lsh_e2e_fused_state",
         eligible_b1024=st is not None,
         n_codes_live=None if fused is None else fused["n_codes_live"],
         l_max=None if fused is None else fused["l_max"],
         rows=None if fused is None else len(fused["row2elem"]))

    for tag, env in (("fused", {}),
                     ("twodispatch", {"SMQTK_TPU_NO_LSH_FUSED": "1"})):
        with _env(env):
            for label, qs, iters in (("b128", q128, 3),
                                     ("b1024", q_large, 2)):
                res = idx.nn_many(qs, 10)       # warm
                t0 = time.perf_counter()
                for _ in range(iters):
                    res = idx.nn_many(qs, 10)
                dt = (time.perf_counter() - t0) / iters
                kw = {}
                if label == "b128":
                    got = [[e.uuid() for e in r] for r, _ in res]
                    kw["recall_at_10"] = round(_recall_at_10(got, truth), 4)
                emit(metric=f"{PREFIX}lsh_e2e_itq128_{tag}_{label}",
                     value=round(len(qs) / dt, 0), unit="queries/s",
                     dataset=dataset, **kw)


def bench_mrpt(device: str = "cuda", n: int = 262_144, d: int = 960,
               configs=((8, 9), (16, 7), (32, 6))) -> None:
    """MRPT at the GIST shape (``bench_all.py:424-455``): build seconds,
    queries/s at B=64 and recall@10 for each (trees, depth)."""
    from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (
        MRPTNearestNeighborsIndex,
    )

    db, queries, dataset = _load_or_make("gist_base.fvecs", n, d, 1.0,
                                         seed=4)
    n = db.shape[0]
    elems = _elements(db)
    nq = min(64, queries.shape[0])
    queries = queries[:nq]
    truth = _exact_ground_truth(db, queries)
    q_elems = _elements(queries, "q")
    for trees, depth in configs:
        idx = MRPTNearestNeighborsIndex(num_trees=trees, depth=depth,
                                        random_seed=0, device=device)
        t0 = time.perf_counter()
        idx.build_index(elems)
        build_s = time.perf_counter() - t0
        res = idx.nn_many(q_elems, 10)
        t0 = time.perf_counter()
        for _ in range(3):
            res = idx.nn_many(q_elems, 10)
        dt = (time.perf_counter() - t0) / 3
        got = [[e.uuid() for e in r] for r, _ in res]
        emit(metric=f"{PREFIX}mrpt_gist256k_t{trees}_d{depth}",
             value=round(nq / dt, 0), unit="queries/s", dataset=dataset,
             build_wall_s=round(build_s, 1),
             recall_at_10=round(_recall_at_10(got, truth), 4))
        del idx


def bench_sq8(device: str = "cuda", n: int = 1_000_000) -> None:
    """The SQ8 flat scan at the SIFT shape (``bench_all.py:458-504``):
    queries/s at B=128 and recall@10 against float64. Stage 1 takes the
    card's routing, as the flat store does: K1's int8 form on a card, the
    streamed plain scan on the CPU (the JAX function's ``codes_t`` on a
    TPU, ``:485-488``)."""
    from smqtk_indexing_tpu_torch.ops import sq8
    from smqtk_indexing_tpu_torch.ops.device import (
        capacity_for, kernel_tier, pad_rows_np, resolve_device,
    )

    dev = resolve_device(device)
    d = 128
    db, queries, dataset = _load_or_make("sift_base.fvecs", n, d, 218.0,
                                         seed=6)
    n = db.shape[0]
    truth = _exact_ground_truth(db, queries)
    cap = capacity_for(n)
    a, b = sq8.sq8_train(db)
    codes_np = np.zeros((cap, d), dtype=np.int8)
    codes_np[:n] = sq8.sq8_encode_np(db, a, b)
    codes = torch.from_numpy(codes_np).to(dev)
    a_t, b_t = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    s2, nrm = sq8.sq8_row_stats(codes, a_t, b_t)
    valid = torch.zeros(cap, dtype=torch.bool, device=dev)
    valid[:n] = True
    nq = queries.shape[0]
    qb = torch.from_numpy(pad_rows_np(queries, max(nq, 128), d)).to(dev)
    fused = kernel_tier(dev) == "cuda"

    def scan():
        return sq8.sq8_topk(codes, a_t, b_t, s2, nrm, valid, qb, k=16,
                            fused=fused)

    scan()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(3):
        _, rr = scan()
    got = rr.cpu().numpy()[:nq, :10]
    dt = (time.perf_counter() - t0) / 3
    emit(metric=f"{PREFIX}sq8_sift1m_scan_b128", value=round(nq / dt, 0),
         unit="queries/s", dataset=dataset,
         recall_at_10=round(_recall_at_10(got, truth), 4),
         fused_stage1=fused,
         note="int8 codes, 4x capacity vs f32; exact re-rank on "
              "dequantized winners")


def sections(device: str = "cuda", sizes=None) -> dict:
    """The sections of ``bench_all.py:507-536``, by name, on ``device``.
    ``sizes`` maps a function's name (``itq``, ``lsh_e2e``, ``ivf``,
    ``mrpt``, ``sq8``; the four IVF sections share ``ivf``) to keyword
    arguments that replace its defaults, ``nprobes`` included."""
    sizes = sizes or {}

    def ivf(tags, **kw):
        return lambda: bench_ivf(tags, **{**kw, "device": device,
                                          **sizes.get("ivf", {})})
    return {
        "itq": lambda: bench_itq_linear(device, **sizes.get("itq", {})),
        "lsh_e2e": lambda: bench_lsh_e2e(device,
                                         **sizes.get("lsh_e2e", {})),
        "ivf": ivf(("", "_sq8", "_pq16")),
        "mrpt": lambda: bench_mrpt(device, **sizes.get("mrpt", {})),
        "sq8": lambda: bench_sq8(device, **sizes.get("sq8", {})),
        # Same-process A/B: the row-major sq8 layout against the tiled
        # routing (exact and score) and the code tier.
        "ivf_code": ivf(("_sq8_rowmajor", "_sq8", "_sq8_score", "_code",
                         "_code_score"), nprobes=(1, 4, 16, 64)),
        # The PQ counterpart, with OPQ16 and residual PQ16.
        "ivf_code_pq": ivf(("_pq16_rowmajor", "_pq16", "_code_pq16",
                            "_code_pq16_score", "_opq16",
                            "_code_opq16_score", "_pq16_res",
                            "_code_pq16_res_score"),
                           nprobes=(1, 4, 16, 64)),
        # The correlated (rank-8) recipe's codec ladder; only when named.
        "ivf_corr": ivf(("_pq16", "_opq16", "_pq16_res", "_opq16_res"),
                        nprobes=(1, 4, 16, 64), rank=8, label="corr1m"),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sections", nargs="*")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    table = sections(args.device)
    picked = [s for s in args.sections if s in table] \
        or [s for s in table if s != "ivf_corr"]
    emit(metric=f"{PREFIX}bench_all_start", value=time.time(),
         unit="epoch_s", sections=picked)
    for name in picked:
        table[name]()
    emit(metric=f"{PREFIX}bench_all_done", value=time.time(), unit="epoch_s")


if __name__ == "__main__":
    main()
