"""
Exactness drives at scale on the card: the nine checks of the
repository's ``tools/verify_exactness.py`` (``:1-26``), at its sizes
(1,000,000 x 128 rows, uniform * 218 from seed 0, 64 queries; 262,144 rows
for the PQ and code-tier checks), through the port.

1. Flat fused scan (K1, then the exact f32 stage 2) at 1M, under each
   ``SMQTK_TPU_STAGE1`` mode (``split3``, ``native``, ``highest``): rows
   identical to the float64 top-10. Each mode is reported; a mode that
   misses fails the check with its count of queries whose rows differ.
2. IVF nprobe=1 at 1M: each answer is the float64 scan of exactly the
   nearest original list's members (FAISS semantics).
3. SQ8 scan at 1M (K1's int8 form on a card): distances equal float64
   over the dequantized rows.
4. PQ scan at 256K: distances equal float64 over the reconstructions.
5. PQ16 code tier (K8, the exact re-rank through K3) at 256K, full probe:
   at least 9 of the 10 float64 neighbours over the reconstructions,
   distances of the returned rows equal to float64; score mode's top-1
   among the float64 top-5.
6. Residual PQ16 code tier: check 5 over ``c[list] + r_hat``.
7. Sharded SQ8 code tier, ``n_devices=8``: the same top-1 and distances
   as the single-device index at 256K. The port's mesh never falls back
   to the CPU, so the eight shards sit on one device (``[device] * 8``);
   the JAX tool's ``XLA_FLAGS`` preamble has no counterpart.
8. Metric axis on the code tier: inner_product (sq8, pq16) answers and
   distances against a float64 oracle over the decoded codes (atol 3e-4
   of the largest |score|); cosine (sq8) against the float64 angular
   oracle (atol 1e-2). The JAX note that the split-bf16 LUT / fold
   precision is TPU-only behaviour has no counterpart here: the port's
   K8 table is full f32 (``ivf_scan.pq_lut``, an f32 product with TF32
   refused), summed in f32 by the kernel, and K7 folds the query in f32.
9. Cosine residual PQ16 code tier: every returned row within the true
   10th angular distance + 2e-3, distances equal to float64 over the
   reconstructions (atol 1e-2).

    python -m smqtk_indexing_tpu_torch.tools.verify_exactness [id ...]
        [--device cpu] [--n N]

Every selected check runs; a failing one is reported and the others go
on. The exit status is 1 if any check failed. On the CPU the kernels'
plain versions run, at sizes a caller chooses (``--n``).
"""
from __future__ import annotations

import argparse
import sys
import time
import warnings

import numpy as np
import torch

from smqtk_indexing_tpu_torch.bench_all import _elements, _env
from smqtk_indexing_tpu_torch.ops import fused_scan, pq, sq8
from smqtk_indexing_tpu_torch.ops.device import (
    capacity_for, kernel_tier, pad_rows_np, resolve_device,
    stage1_precision,
)

N, D, B, K = 1_000_000, 128, 64, 10
#: Rows of the PQ and code-tier checks.
N_PQ = 262_144
#: Queries of the model-level checks.
Q_MODEL = 8
#: ``SMQTK_TPU_STAGE1`` modes check 1 runs under.
MODES = ("split3", "native", "highest")
CHECKS = tuple(range(1, 10))


def _log(msg: str) -> None:
    print(f"[{time.strftime('%H:%M:%S')}] {msg}", flush=True)


def _require(ok: bool, what) -> None:
    if not ok:
        raise AssertionError(what)


class Drive:
    """The checks' shared data, on one device: ``n`` rows and ``B``
    queries (uniform * 218, seed 0), the first ``min(N_PQ, n)`` rows'
    elements, and the indexes built so far (a check's index is built
    once per drive)."""

    def __init__(self, n: int = N, device: str = "cuda"):
        rng = np.random.default_rng(0)
        self.db = rng.random((n, D), dtype=np.float32) * 218.0
        self.q = rng.random((B, D), dtype=np.float32) * 218.0
        self.n = n
        self.n_pq = min(N_PQ, n)
        self.device = device
        self.dev = resolve_device(device)
        self.cap = capacity_for(n)
        self._elements = {}
        self._indexes = {}

    def elements(self, n: int):
        if n not in self._elements:
            self._elements[n] = _elements(self.db[:n])
        return self._elements[n]

    def q_elems(self):
        return _elements(self.q[:Q_MODEL], "q")

    def index(self, rows: int, **kw):
        """An ``IvfNearestNeighborsIndex`` over the first ``rows`` rows,
        built once for each configuration."""
        from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
            IvfNearestNeighborsIndex,
        )
        key = (rows, tuple(sorted(kw.items())))
        if key not in self._indexes:
            idx = IvfNearestNeighborsIndex(random_seed=0,
                                           device=kw.pop("device",
                                                         self.device),
                                           **kw)
            idx.build_index(self.elements(rows))
            self._indexes[key] = idx
        return self._indexes[key]

    def tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dev)

    def valid(self, n: int, cap: int) -> torch.Tensor:
        v = torch.zeros(cap, dtype=torch.bool, device=self.dev)
        v[:n] = True
        return v


def _query(idx, q_elems):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return idx.nn_many(q_elems, K)


def check_1(drv: Drive, modes=MODES) -> dict:
    db, q = drv.db, drv.q
    q64 = q.astype(np.float64)
    d2 = (q64 ** 2).sum(1)[:, None] \
        + (db.astype(np.float64) ** 2).sum(1)[None, :] \
        - 2.0 * (q64 @ db.astype(np.float64).T)
    truth = np.argsort(d2, axis=1)[:, :K]
    del d2
    sq = np.zeros(drv.cap, np.float32)
    sq[:drv.n] = np.einsum("ij,ij->i", db, db)
    dev_db = drv.tensor(pad_rows_np(db, drv.cap, D))
    dev_sq, valid, qd = drv.tensor(sq), drv.valid(drv.n, drv.cap), \
        drv.tensor(q)
    differ = {}
    for mode in modes:
        with _env({"SMQTK_TPU_STAGE1": mode}):
            _, rr = fused_scan.flat_topk_fused(
                dev_db, dev_sq, valid, qd, k=16,
                precision=stage1_precision())
        wrong = rr.cpu().numpy()[:, :K] != truth
        differ[mode] = int(wrong.any(axis=1).sum())
        _log(f"1. flat fused scan, SMQTK_TPU_STAGE1={mode}: "
             f"{B - differ[mode]} of {B} queries' rows identical to "
             f"float64 at n={drv.n} ({int(wrong.sum())} of {B * K} "
             "result rows differ)")
    _require(not any(differ.values()),
             f"flat fused rows != float64 (queries that differ: {differ})")
    return differ


def check_2(drv: Drive) -> None:
    idx = drv.index(drv.n, n_lists=256, nprobe=1, kmeans_iterations=4)
    cents = idx._centroids_np[:, :D]
    assign = np.empty(drv.n, np.int64)
    for row, uid in enumerate(idx._row2uid):
        assign[uid] = int(idx._assign_host[row])
    for j, (e_list, _) in enumerate(_query(idx, drv.q_elems())):
        qj = drv.q[j]
        c_near = int(np.argmin(((qj[None, :] - cents) ** 2).sum(1)))
        members = np.where(assign == c_near)[0]
        dm = ((qj[None].astype(np.float64)
               - drv.db[members].astype(np.float64)) ** 2).sum(1)
        expect = [int(members[i]) for i in np.argsort(dm)[:len(e_list)]]
        got = [e.uuid() for e in e_list]
        _require(got == expect, (j, got[:5], expect[:5]))
    _log(f"2. IVF nprobe=1 == exact scan of the nearest list at "
         f"n={drv.n} OK")


def check_3(drv: Drive) -> None:
    a, bb = sq8.sq8_train(drv.db)
    codes = np.zeros((drv.cap, D), np.int8)
    codes[:drv.n] = sq8.sq8_encode_np(drv.db, a, bb)
    cj, aj, bj = drv.tensor(codes), drv.tensor(a), drv.tensor(bb)
    s2, nrm = sq8.sq8_row_stats(cj, aj, bj)
    dd, rr = sq8.sq8_topk(cj, aj, bj, s2, nrm, drv.valid(drv.n, drv.cap),
                          drv.tensor(drv.q), k=16,
                          fused=kernel_tier(drv.dev) == "cuda")
    got_r = rr.cpu().numpy()[:, :K]
    got_d = dd.cpu().numpy()[:, :K]
    deq = codes[got_r].astype(np.float64) * a + bb
    ref_d = np.sqrt(((deq - drv.q[:, None, :].astype(np.float64)) ** 2)
                    .sum(-1))
    _require(np.allclose(got_d, ref_d, atol=1e-3, rtol=1e-5),
             np.abs(got_d - ref_d).max())
    _log(f"3. SQ8 distances exact vs float64 dequantized rows at "
         f"n={drv.n} OK")


def check_4(drv: Drive) -> None:
    n_pq = drv.n_pq
    cbs = pq.pq_train(drv.db[:n_pq], 16, n_iter=5, device=drv.dev)
    codes = pq.pq_encode_np(drv.db[:n_pq], cbs, device=drv.dev)
    cj, cbj = drv.tensor(codes), drv.tensor(cbs)
    s2 = pq.pq_row_stats(cj, cbj)
    dd, rr = pq.pq_topk(cj, cbj, s2, drv.valid(n_pq, n_pq),
                        drv.tensor(drv.q), k=16)
    got_r = rr.cpu().numpy()[:, :K]
    got_d = dd.cpu().numpy()[:, :K]
    rows = pq.pq_decode_np(codes, cbs)[got_r].astype(np.float64)
    ref_d = np.sqrt(((rows - drv.q[:, None, :].astype(np.float64)) ** 2)
                    .sum(-1))
    _require(np.allclose(got_d, ref_d, atol=1e-3, rtol=1e-5),
             np.abs(got_d - ref_d).max())
    _log(f"4. PQ distances exact vs float64 reconstruction at n={n_pq} OK")


def _codec_queries(idx, q: np.ndarray) -> np.ndarray:
    """Queries in the PQ codec grid (the perm is orthogonal)."""
    perm = idx._pq_grid()[2]
    q_c = np.zeros((q.shape[0], len(perm)))
    q_c[:, :D] = q
    return q_c[:, perm]


def _pq_code_contract(drv: Drive, idx, rec: np.ndarray, what: str) -> None:
    """Checks 5 and 6: at least K - 1 of the float64 top-K over the
    reconstructions ``rec`` (rows in the index's order), the returned
    rows' distances equal to float64, ascending."""
    uid_of_row = np.asarray(idx._row2uid)
    q_c = _codec_queries(idx, drv.q)
    d2 = (q_c ** 2).sum(1)[:, None] + (rec ** 2).sum(1)[None, :] \
        - 2.0 * (q_c @ rec.T)
    row_of_uid = {int(u): r for r, u in enumerate(uid_of_row)}
    for j, (e_list, dists) in enumerate(_query(idx, drv.q_elems())):
        expect = {int(uid_of_row[r]) for r in np.argsort(d2[j])[:K]}
        got = [e.uuid() for e in e_list]
        _require(len(expect & set(got)) >= K - 1, (what, j, got, expect))
        ref_d = np.sqrt(np.maximum(
            d2[j][[row_of_uid[u] for u in got]], 0.0))
        _require(np.allclose(dists, ref_d, atol=1e-2, rtol=1e-4),
                 (what, j, np.abs(np.asarray(dists) - ref_d).max()))
        _require(list(dists) == sorted(dists), (what, j))
    return d2, uid_of_row


def check_5(drv: Drive) -> None:
    idx = drv.index(drv.n_pq, n_lists=64, nprobe=64, kmeans_iterations=4,
                    dtype="pq16", storage="code")
    rec = pq.pq_decode_np(idx._host, idx._code_cb).astype(np.float64)
    d2, uid_of_row = _pq_code_contract(drv, idx, rec, "pq16 exact")
    idx.rerank = "score"
    try:
        res = _query(idx, drv.q_elems())
    finally:
        idx.rerank = "exact"
    for j, (e_list, _) in enumerate(res):
        top5 = {int(uid_of_row[r]) for r in np.argsort(d2[j])[:5]}
        _require(e_list[0].uuid() in top5, ("pq16 score", j))
    _log(f"5. PQ code tier (K8, K3) exact vs float64 at n={drv.n_pq} OK")


def check_6(drv: Drive) -> None:
    idx = drv.index(drv.n_pq, n_lists=64, nprobe=64, kmeans_iterations=4,
                    dtype="pq16", storage="code", pq_residual=True)
    cents_c = idx._pq_cents_codec(idx._code_rot).astype(np.float64)
    rec = pq.pq_decode_np(idx._host, idx._code_cb).astype(np.float64) \
        + cents_c[idx._assign_host]
    _pq_code_contract(drv, idx, rec, "residual pq16 exact")
    _log(f"6. RESIDUAL PQ code tier exact vs float64 at n={drv.n_pq} OK")


def check_7(drv: Drive) -> None:
    kw = dict(n_lists=64, nprobe=64, kmeans_iterations=4, dtype="sq8",
              storage="code")
    shard = "cuda:0" if str(drv.dev) == "cuda" else str(drv.dev)
    idx_sh = drv.index(drv.n_pq, n_devices=8, device=(shard,) * 8, **kw)
    idx_1 = drv.index(drv.n_pq, **kw)
    res_sh = _query(idx_sh, drv.q_elems())
    res_1 = _query(idx_1, drv.q_elems())
    for j, ((e_s, d_s), (e_1, d_1)) in enumerate(zip(res_sh, res_1)):
        _require(e_s[0].uuid() == e_1[0].uuid(), j)
        _require(np.allclose(d_s, d_1, atol=1e-3, rtol=1e-5),
                 (j, np.abs(np.asarray(d_s) - np.asarray(d_1)).max()))
    _log(f"7. SHARDED code tier (8 shards on {shard}) == single-device "
         f"at n={drv.n_pq} OK")


def _decoded(idx) -> np.ndarray:
    if idx._pq_m(idx.dtype) is not None:
        return pq.pq_decode_np(idx._host, idx._code_cb).astype(np.float64)
    return idx._host.astype(np.float64) * idx._code_a + idx._code_b


def check_8(drv: Drive) -> None:
    kw = dict(n_lists=64, nprobe=64, kmeans_iterations=4, storage="code")
    for dtype in ("sq8", "pq16"):
        idx = drv.index(drv.n_pq, dtype=dtype, metric="inner_product", **kw)
        rec = _decoded(idx)
        q_c = drv.q.astype(np.float64) if idx._pq_m(dtype) is None \
            else _codec_queries(idx, drv.q)
        uid_of_row = np.asarray(idx._row2uid)
        row_of_uid = {int(u): r for r, u in enumerate(uid_of_row)}
        for j, (e_list, dists) in enumerate(_query(idx, drv.q_elems())):
            d_ref = -(rec @ q_c[j])
            expect = {int(uid_of_row[r])
                      for r in np.argsort(d_ref, kind="stable")[:K]}
            got = [e.uuid() for e in e_list]
            _require(len(expect & set(got)) >= K - 1,
                     (dtype, j, got, sorted(expect)))
            ref_d = d_ref[[row_of_uid[u] for u in got]]
            # Unnormalised 218-scale rows: IP magnitudes ~1e5-1e6, so the
            # bound is relative to the score scale.
            scale = np.abs(ref_d).max()
            _require(np.allclose(dists, ref_d, atol=3e-4 * scale),
                     (dtype, j, np.abs(np.asarray(dists) - ref_d).max(),
                      scale))
            _require(list(dists) == sorted(dists), (dtype, j))
        _log(f"8a. code-tier inner_product ({dtype}) exact vs float64 "
             f"decoded codes at n={drv.n_pq} OK")

    idx = drv.index(drv.n_pq, dtype="sq8", metric="cosine", **kw)
    rec = _decoded(idx)
    uid_of_row = np.asarray(idx._row2uid)
    row_of_uid = {int(u): r for r, u in enumerate(uid_of_row)}
    nrm = np.linalg.norm(rec, axis=1)
    _require(np.allclose(nrm, 1.0, atol=5e-2), (nrm.min(), nrm.max()))
    for j, (e_list, dists) in enumerate(_query(idx, drv.q_elems())):
        qn = drv.q[j].astype(np.float64)
        qn = qn / np.linalg.norm(qn)
        sim = np.clip((rec @ qn) / np.where(nrm == 0, 1.0, nrm), -1.0, 1.0)
        d_ref = 2.0 * np.arccos(sim) / np.pi
        expect = {int(uid_of_row[r])
                  for r in np.argsort(d_ref, kind="stable")[:K]}
        got = [e.uuid() for e in e_list]
        _require(len(expect & set(got)) >= K - 1, (j, got, sorted(expect)))
        ref_d = d_ref[[row_of_uid[u] for u in got]]
        _require(np.allclose(dists, ref_d, atol=1e-2),
                 (j, np.abs(np.asarray(dists) - ref_d).max()))
    _log(f"8b. code-tier cosine (sq8) == float64 angular oracle at "
         f"n={drv.n_pq} OK")


def check_9(drv: Drive) -> None:
    idx = drv.index(drv.n_pq, n_lists=64, nprobe=64, kmeans_iterations=4,
                    dtype="pq16", storage="code", metric="cosine",
                    pq_residual=True)
    _require(idx._cents_codec_dev is not None, "no codec-frame centroids")
    rec = pq.pq_decode_np(idx._host, idx._code_cb).astype(np.float64) \
        + idx._pq_cents_codec(None)[idx._assign_host].astype(np.float64)
    nrm = np.linalg.norm(rec, axis=1)
    # PQ16 reconstructions of unit rows scatter wider than sq8's.
    _require(np.allclose(nrm, 1.0, atol=0.2), (nrm.min(), nrm.max()))
    q_c = _codec_queries(idx, drv.q)
    uid_of_row = np.asarray(idx._row2uid)
    row_of_uid = {int(u): r for r, u in enumerate(uid_of_row)}
    for j, (e_list, dists) in enumerate(_query(idx, drv.q_elems())):
        qc = q_c[j] / np.linalg.norm(q_c[j])
        sim = np.clip((rec @ qc) / np.where(nrm == 0, 1.0, nrm), -1.0, 1.0)
        d_ref = 2.0 * np.arccos(sim) / np.pi
        got = [e.uuid() for e in e_list]
        ref_d = d_ref[[row_of_uid[u] for u in got]]
        # Positive-quadrant data puts every angular distance near one
        # value: the contract is the distance boundary (JAX :402-411).
        k_boundary = np.sort(d_ref)[K - 1]
        _require((ref_d <= k_boundary + 2e-3).all(),
                 (j, ref_d.max(), k_boundary))
        _require(np.allclose(dists, ref_d, atol=1e-2),
                 (j, np.abs(np.asarray(dists) - ref_d).max()))
    _log(f"9. code-tier COSINE RESIDUAL pq16 == float64 angular oracle "
         f"over reconstructions at n={drv.n_pq} OK")


def main(checks=None, n: int = N, device: str = "cuda") -> dict:
    """Run ``checks`` (default all nine) on a :class:`Drive` of ``n`` rows;
    return each check's outcome, ``"ok"`` or its failure."""
    sel = sorted(set(checks or CHECKS))
    unknown = set(sel) - set(CHECKS)
    if unknown:
        raise ValueError(f"unknown check id(s) {sorted(unknown)}; "
                         f"valid: {list(CHECKS)}")
    drv = Drive(n, device)
    _log(f"device {drv.dev} ({kernel_tier(drv.dev)}), n={n}, B={B}")
    outcome = {}
    for c in sel:
        t0 = time.perf_counter()
        try:
            globals()[f"check_{c}"](drv)
            outcome[c] = "ok"
        except AssertionError as exc:
            outcome[c] = f"FAILED: {exc}"
            _log(f"{c}. FAILED: {exc}")
        _log(f"{c}. took {time.perf_counter() - t0:.1f} s")
    failed = [c for c, v in outcome.items() if v != "ok"]
    _log(f"EXACTNESS DRIVES: passed {[c for c in sel if c not in failed]}, "
         f"failed {failed}")
    return outcome


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("checks", nargs="*", type=int)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=N)
    args = ap.parse_args()
    result = main(args.checks, args.n, args.device)
    sys.exit(1 if any(v != "ok" for v in result.values()) else 0)
