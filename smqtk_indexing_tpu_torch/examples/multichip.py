"""
Sharded indexes on a device mesh, and the multi-device dry run.

Counterpart of ``examples/multichip.py`` and of
``__graft_entry__.dryrun_multichip``. ``n_devices`` shards an index over
cards ``cuda:0`` .. ``cuda:n-1``; too few cards raise (no fallback to the
CPU). ``--device cpu`` puts every shard on the CPU, and ``--devices
cuda:0,cuda:0`` places each shard explicitly (one card may hold several).

    python -m smqtk_indexing_tpu_torch.examples.multichip --n-devices 4
    python -m smqtk_indexing_tpu_torch.examples.multichip --device cpu
    python -m smqtk_indexing_tpu_torch.examples.multichip --devices \\
        cuda:0,cuda:0,cuda:0,cuda:0
    python -m smqtk_indexing_tpu_torch.examples.multichip --dryrun 8 \\
        --device cpu

``dryrun_multichip(n)`` runs the sharded train and query pipeline end to
end and raises on the first disagreement: a data-parallel k-means step,
the sharded flat, IVF, Hamming, MRPT, SQ8, PQ and re-rank scans, a 2-D
(dcn, shard) mesh, and through the public index API the sharded code tier
(SQ8; inner_product and cosine; cosine residual PQ) and the rows tier's
residual PQ, each against its single-device index.
"""
from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorMemoryElement, MemoryDescriptorSet,
)
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
    IvfNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.ops import pq as pq_ops
from smqtk_indexing_tpu_torch.ops import scan
from smqtk_indexing_tpu_torch.ops import sq8 as sq8_ops
from smqtk_indexing_tpu_torch.ops.mrpt import build_trees, project_all
from smqtk_indexing_tpu_torch.parallel import (
    make_mesh, shard_csr, shard_leaf_tables, shard_rows,
    sharded_flat_topk, sharded_hamming_topk, sharded_ivf_query,
    sharded_kmeans_step, sharded_mrpt_query, sharded_pq_topk,
    sharded_rerank_topk, sharded_sq8_topk,
)
from smqtk_indexing_tpu_torch.utils.bits import pack_bit_vectors_u32


def _first_rows_are(rows: torch.Tensor, what: str, b: int) -> None:
    got = rows[:, 0].cpu().numpy()
    if not np.array_equal(got, np.arange(b)):
        raise AssertionError(f"{what} self-match failed: {got}")


def _agree(one, many, what: str, first: bool = True) -> None:
    for (e1, d1), (en, dn) in zip(one, many):
        if first and e1[0].uuid() != en[0].uuid():
            raise AssertionError(f"{what} self-match failed")
        if not np.allclose(d1, dn, atol=1e-4):
            raise AssertionError(f"{what} diverges from single-device")


def dryrun_multichip(n_devices: int, device: str = "cuda",
                     devices: Optional[Sequence[str]] = None) -> None:
    """
    Run the sharded pipeline on an ``n_devices`` mesh (and a 2-D one) and
    check each step (``__graft_entry__.py:54-350``).

    :param device: ``"cuda"`` (cards 0 .. n-1; too few raise) or
        ``"cpu"`` (n CPU shards); ignored when ``devices`` lists the
        shards.
    :raises AssertionError: a step disagrees.
    """
    mesh = make_mesh(n_devices, devices=devices, device=device)
    dev0 = mesh.first
    rng = np.random.default_rng(0)
    n, d, b, k, c = 64 * n_devices, 128, 8, 4, 8
    db = rng.normal(size=(n, d)).astype(np.float32)
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    q = db[:b] + 0.01
    ones = np.ones(n, dtype=bool)
    db_s, sq_s, nm_s, va_s = (shard_rows(mesh, a)
                              for a in (db, sq, np.sqrt(sq), ones))

    # 1. A data-parallel Lloyd step (partial sums added in shard order).
    init = db[rng.choice(n, c, replace=False)]
    cents, assigns = sharded_kmeans_step(mesh, db_s, va_s, init)
    assigns = torch.cat([a.to(dev0) for a in assigns]).cpu().numpy()
    assert tuple(cents.shape) == (c, d) and assigns.shape == (n,)

    # 2. The sharded exhaustive scan against the single-device one.
    dists, rows = sharded_flat_topk(mesh, db_s, sq_s, nm_s, va_s, q, k=k)
    t = [torch.from_numpy(a).to(dev0) for a in (db, sq, np.sqrt(sq), ones)]
    ref_d, _ = scan.flat_topk(*t, torch.from_numpy(q).to(dev0), k=k)
    _first_rows_are(rows, "sharded query", b)
    if not torch.allclose(dists, ref_d, atol=1e-5):
        raise AssertionError("sharded distances diverge from single-device")

    # 3. The sharded IVF list gather over the trained centroids.
    order = np.argsort(assigns, kind="stable")
    db_sorted, sq_sorted = db[order], sq[order]
    lens_np = np.bincount(assigns, minlength=c).astype(np.int64)
    offs_np = np.zeros(c, dtype=np.int64)
    offs_np[1:] = np.cumsum(lens_np)[:-1]
    loc_off, loc_len = shard_csr(offs_np, lens_np, n, n_devices)
    _, ivf_r = sharded_ivf_query(
        mesh, shard_rows(mesh, db_sorted), shard_rows(mesh, sq_sorted),
        shard_rows(mesh, np.sqrt(sq_sorted)), va_s, cents,
        shard_rows(mesh, loc_off.astype(np.int64)),
        shard_rows(mesh, loc_len.astype(np.int64)), db_sorted[:b] + 0.001,
        k=k, nprobe=c, l_max=int(max(lens_np.max(), 1)))
    _first_rows_are(ivf_r, "sharded IVF", b)

    # 4. The sharded Hamming scan.
    codes = rng.integers(0, 2, size=(n, 64)).astype(bool)
    packed = pack_bit_vectors_u32(codes).view(np.int32)
    hd, _ = sharded_hamming_topk(mesh, shard_rows(mesh, packed), va_s,
                                 packed[:b], k=2)
    if hd[:, 0].abs().sum().item() != 0:
        raise AssertionError("sharded hamming self-match failed")

    # 5. The sharded MRPT query over per-shard leaf tables.
    t_count, depth = 3, 3
    bases = rng.standard_normal((t_count, d, depth)).astype(np.float32)
    projs = project_all(torch.from_numpy(db).to(dev0),
                        torch.from_numpy(bases).to(dev0)).cpu().numpy()
    splits, leaf_table, offsets = build_trees(projs, depth)
    leaf_loc, off_loc, lmax = shard_leaf_tables(leaf_table, offsets,
                                                n_devices, n)
    lmax_p = 1
    while lmax_p < max(lmax, 1):
        lmax_p *= 2
    _, mr = sharded_mrpt_query(
        mesh, db_s, sq_s, va_s, bases, splits, shard_rows(mesh, leaf_loc),
        shard_rows(mesh, off_loc), q, k=k, depth=depth, leaf_max=lmax_p)
    _first_rows_are(mr, "sharded MRPT", b)

    # 6. The compressed codecs and the LSH candidate re-rank.
    a8, b8 = sq8_ops.sq8_train(db)
    codes8 = torch.from_numpy(sq8_ops.sq8_encode_np(db, a8, b8))
    a8_t, b8_t = torch.from_numpy(a8), torch.from_numpy(b8)
    s2_8, nrm_8 = sq8_ops.sq8_row_stats(codes8, a8_t, b8_t)
    _, sr = sharded_sq8_topk(
        mesh, shard_rows(mesh, codes8), a8_t, b8_t, shard_rows(mesh, s2_8),
        shard_rows(mesh, nrm_8), va_s, q, k=k)
    _first_rows_are(sr, "sharded SQ8", b)
    cbs = pq_ops.pq_train(db, 16, n_iter=3, device=dev0)
    codes_pq = torch.from_numpy(pq_ops.pq_encode_np(db, cbs, device=dev0))
    s2_pq = pq_ops.pq_row_stats(codes_pq, torch.from_numpy(cbs))
    pd_, _ = sharded_pq_topk(mesh, shard_rows(mesh, codes_pq), cbs,
                             shard_rows(mesh, s2_pq), va_s, q, k=k)
    if not torch.isfinite(pd_).all():   # a lossy codec: it must run
        raise AssertionError("sharded PQ returned no neighbours")
    cand = np.ascontiguousarray(
        np.broadcast_to(db[None, :b * 2], (b, b * 2, d)))
    if (b * 2) % n_devices == 0:
        _, rr_ = sharded_rerank_topk(
            mesh, q, shard_rows(mesh, cand, axis=1),
            shard_rows(mesh, np.ones((b, b * 2), bool), axis=1), k=4)
        _first_rows_are(rr_, "sharded re-rank", b)

    # 7. A 2-D (dcn, shard) mesh: the merge within each slice, then across.
    if n_devices >= 4:
        mesh2 = make_mesh(n_devices, devices=devices, device=device,
                          dcn=n_devices // 4)
        d2, r2 = sharded_flat_topk(
            mesh2, *(shard_rows(mesh2, a)
                     for a in (db, sq, np.sqrt(sq), ones)), q, k=k)
        _first_rows_are(r2, "2-D mesh query", b)
        if not torch.allclose(d2.to(dev0), ref_d, atol=1e-5):
            raise AssertionError("2-D mesh distances diverge")

    # 8-11. The public index API: each sharded cell against its
    # single-device index on the same data and seed.
    vecs = rng.normal(size=(2000, 16)).astype(np.float32)
    els = [DescriptorMemoryElement(i, vecs[i]) for i in range(2000)]
    place = dict(device=list(devices)) if devices else dict(device=device)

    def pair(**kw):
        one = IvfNearestNeighborsIndex(
            descriptor_set=MemoryDescriptorSet(), device=str(dev0), **kw)
        one.build_index(els)
        many = IvfNearestNeighborsIndex(
            descriptor_set=MemoryDescriptorSet(), n_devices=n_devices,
            **place, **kw)
        many.build_index(els)
        if many._mesh is None:
            raise AssertionError(f"{kw} did not build on a mesh")
        return one, many

    code1, codeN = pair(n_lists=8, nprobe=8, storage="code", dtype="sq8",
                        random_seed=0)
    _agree(code1.nn_many(els[:4], 4), codeN.nn_many(els[:4], 4),
           "sharded code tier")
    codeN.remove_from_index([0])
    if 0 in {x.uuid() for x in codeN.nn(els[1], 3)[0]}:
        raise AssertionError("sharded code tier served a removed row")
    res1, resN = pair(n_lists=8, nprobe=8, storage="rows", dtype="pq4",
                      pq_residual=True, random_seed=0)
    if resN._row2list_dev is None:
        raise AssertionError("sharded rows residual lost its list map")
    _agree(res1.nn_many(els[:4], 4), resN.nn_many(els[:4], 4),
           "sharded rows residual", first=False)
    for metric in ("inner_product", "cosine"):
        m1, mN = pair(n_lists=8, nprobe=8, storage="code", dtype="sq8",
                      metric=metric, random_seed=0)
        _agree(m1.nn_many(els[:4], 4), mN.nn_many(els[:4], 4),
               f"sharded {metric}")
    cr1, crN = pair(n_lists=8, nprobe=8, storage="code", dtype="pq4",
                    metric="cosine", pq_residual=True, random_seed=0)
    if crN._cents_codec_dev is None:
        raise AssertionError("sharded cosine residual lost its centroids")
    _agree(cr1.nn_many(els[:4], 4), crN.nn_many(els[:4], 4),
           "sharded cosine residual", first=False)
    print(f"dryrun_multichip({n_devices}) on {mesh}: kmeans step + sharded "
          "flat/hamming/IVF/MRPT/SQ8/PQ/re-rank + sharded code tier + "
          "sharded rows residual + sharded IP/cosine + sharded cosine "
          "residual + 2-D (dcn, shard) mesh OK")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    p.add_argument("--n-devices", type=int, default=None,
                   help="shards (default: the --devices count, else 2)")
    p.add_argument("--device", default="cuda",
                   help="'cuda' (cards 0 .. n-1) or 'cpu'")
    p.add_argument("--devices", default=None,
                   help="comma-separated device of each shard")
    p.add_argument("--dryrun", type=int, default=None, metavar="N",
                   help="run dryrun_multichip(N) instead of the example")
    args = p.parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, device=args.device, devices=devices)
        return
    n = args.n_devices or (len(devices) if devices else 2)
    place = dict(device=devices) if devices else dict(device=args.device)
    rng = np.random.default_rng(0)
    elems = [DescriptorMemoryElement(i, rng.normal(size=64)
                                     .astype(np.float32))
             for i in range(4096)]
    # The exhaustive scan row-sharded: the top-k a shard, then the merge.
    flat = FlatNearestNeighborsIndex(n_devices=n, **place)
    flat.build_index(elems)
    print(f"mesh: {flat._mesh}")
    res, dists = flat.nn(elems[7], 5)
    print("sharded flat top-5:",
          [(e.uuid(), round(x, 3)) for e, x in zip(res, dists)])
    # IVF sharded by contiguous row spans of the list-sorted layout.
    ivf = IvfNearestNeighborsIndex(n_devices=n, n_lists=16, nprobe=16,
                                   kmeans_iterations=5, random_seed=0,
                                   **place)
    ivf.build_index(elems)
    res, dists = ivf.nn(elems[7], 5)
    print("sharded ivf  top-5:",
          [(e.uuid(), round(x, 3)) for e, x in zip(res, dists)])


if __name__ == "__main__":
    main()
