"""
Codec recall ladder on correlated (rank-8 latent) data, through the port:
the counterpart of the repository's ``tools/recall_ladder.py``. The
correlated regime is where PQ, OPQ and residual encoding separate (iid
synthetic mixtures are PQ-adversarial by construction).

    python -m smqtk_indexing_tpu_torch.tools.recall_ladder [n] [d]
        [--device cpu]        (defaults 200000 64, on the card)

One JSON line per (codec, nprobe) on stdout, with the JAX tool's keys
(``section``, ``dataset``, ``n``, ``d``, ``codec``, ``nprobe``,
``recall_at_10``), and a markdown table per ladder on stderr: first the
rows tier's codecs, then ``cosine_ladder``'s code-tier codecs under
``metric="cosine"`` against a float64 angular oracle. The JAX tool's
CPU run at 200,000 x 64 is ``docs/recall_ladder_200k.jsonl``; the
port's k-means and codecs train on another backend, so its cells can
differ from that record by a trained state's worth.
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from smqtk_indexing_tpu_torch.bench_all import (
    _elements, _exact_ground_truth, _load_or_make, _recall_at_10,
)

#: (label, constructor arguments) of the rows tier's ladder.
CODECS = [
    ("f32", dict(dtype="float32")),
    ("sq8", dict(dtype="sq8")),
    ("pq16", dict(dtype="pq16", pq_residual=False)),
    ("pq16_res", dict(dtype="pq16", pq_residual=True)),
    ("opq16", dict(dtype="opq16", pq_residual=False)),
    ("opq16_res", dict(dtype="opq16", pq_residual=True)),
]

#: The code tier's ladder under ``metric="cosine"``.
COSINE_CODECS = [
    ("cos_sq8", dict(dtype="sq8")),
    ("cos_pq16", dict(dtype="pq16", pq_residual=False)),
    ("cos_pq16_res", dict(dtype="pq16", pq_residual=True)),
    ("cos_opq16_res", dict(dtype="opq16", pq_residual=True)),
]

NPROBES = (1, 2, 4, 8, 16, 32)


def _ladder(section, codecs, els, qels, true_ids, n_lists, nprobes, label,
            n, d, device, **index_kw) -> dict:
    """recall@10 of each codec at each nprobe; one JSON line each."""
    from smqtk_indexing_tpu_torch.data.descriptor import MemoryDescriptorSet
    from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
        IvfNearestNeighborsIndex,
    )
    rows = {}
    for name, kw in codecs:
        idx = IvfNearestNeighborsIndex(
            descriptor_set=MemoryDescriptorSet(), n_lists=n_lists,
            nprobe=nprobes[0], random_seed=0, device=device, **index_kw,
            **kw)
        idx.build_index(els)
        for nprobe in nprobes:
            idx.nprobe = nprobe
            got = [[e.uuid() for e in r[0]] for r in idx.nn_many(qels, 10)]
            rec = _recall_at_10(got, true_ids)
            rows.setdefault(name, {})[nprobe] = rec
            print(json.dumps({"section": section, "dataset": label, "n": n,
                              "d": d, "codec": name, "nprobe": nprobe,
                              "recall_at_10": round(rec, 4)}), flush=True)
        del idx
    return rows


def _table(title: str, codecs, rows, bytes_per, nprobes) -> None:
    print(f"| {title} (bytes/vec) | " + " | ".join(
        f"np={p}" for p in nprobes) + " |", file=sys.stderr)
    print("|" + "---|" * (len(nprobes) + 1), file=sys.stderr)
    for name, _ in codecs:
        cells = " | ".join(f"{rows[name][p]:.3f}" for p in nprobes)
        print(f"| {name} ({bytes_per[name]}B) | {cells} |",
              file=sys.stderr, flush=True)


def main(n: int = 200_000, d: int = 64, rank: int = 8,
         device: str = "cuda", nprobes=NPROBES, nq: int = 128) -> None:
    n_lists = 256 if n <= 300_000 else 1024
    db, queries, label = _load_or_make(
        "corr_base.fvecs", n, d, scale=1.0, seed=5, nq=nq, rank=rank)
    print(f"# dataset={label} n={n} d={d} n_lists={n_lists} "
          f"device={device}", file=sys.stderr, flush=True)
    true_ids = _exact_ground_truth(db, queries, k=10)
    els = _elements(db)
    qels = _elements(queries, "q")
    rows = _ladder("recall_ladder", CODECS, els, qels, true_ids, n_lists,
                   nprobes, label, n, d, device)
    _table("codec", CODECS, rows,
           {"f32": 4 * d, "sq8": d, "pq16": 16, "pq16_res": 16,
            "opq16": 16, "opq16_res": 16}, nprobes)
    cosine_ladder(db, queries, els, qels, n_lists, nprobes, label, n, d,
                  device)


def cosine_ladder(db, queries, els, qels, n_lists, nprobes, label, n, d,
                  device: str = "cuda") -> None:
    """The angular rung (``recall_ladder.py:103-151``): the code tier's
    codecs under ``metric="cosine"`` against a float64 angular oracle."""
    dbn = db.astype(np.float64)
    dbn /= np.maximum(np.linalg.norm(dbn, axis=1, keepdims=True), 1e-30)
    qn = queries.astype(np.float64)
    qn /= np.maximum(np.linalg.norm(qn, axis=1, keepdims=True), 1e-30)
    true_ids = [np.argsort(-(dbn @ qv), kind="stable")[:10].tolist()
                for qv in qn]
    rows = _ladder("recall_ladder_cosine", COSINE_CODECS, els, qels,
                   true_ids, n_lists, nprobes, label, n, d, device,
                   metric="cosine", storage="code")
    _table("cosine codec", COSINE_CODECS, rows,
           {"cos_sq8": d, "cos_pq16": 16, "cos_pq16_res": 16,
            "cos_opq16_res": 16}, nprobes)


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n", nargs="?", type=int, default=200_000)
    ap.add_argument("d", nargs="?", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.n, args.d, device=args.device)
