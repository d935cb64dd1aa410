"""
Device-result -> NNResult assembly for the port's nn_index models.

A copy of ``smqtk_indexing_tpu/models/nn_index/_results.py`` (77 lines):
that module cannot be imported without jax, because its package
``__init__`` imports the JAX index implementations.

The per-query Python loop (mask, per-row uid list-comp, one
``get_many_descriptors`` call per query, per-value ``float()``) is
vectorised where it can be (float conversion via ``tolist``, uid mapping
over only the B*k selected rows, never the full index), and ALL queries'
descriptors are fetched in ONE storage call, regrouped by per-query
counts. Both assemblies are two host spans that tile them: ``results.fetch``
(rows or uid lists to descriptor elements) and ``results.regroup`` (the
distances and the per-query tuples).
"""
from __future__ import annotations

from typing import Hashable, List, Sequence

import numpy as np

from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import NNResult
from smqtk_indexing_tpu_torch.utils.tracing import trace_span


def assemble_results(dists: np.ndarray, rows: np.ndarray,
                     row2uid: Sequence[Hashable],
                     descriptor_set) -> List[NNResult]:
    """
    :param dists: (B, k) float distances, aligned with ``rows``.
    :param rows: (B, k) int row ids, -1 on unfilled slots (trimmed).
    :param row2uid: row -> UID mapping (indexable; only the selected
        B*k entries are touched, so a 100M-row index costs nothing here).
    :param descriptor_set: DescriptorSet for element fetches (order of
        ``get_many_descriptors`` output follows its input order).
    :return: per-query (descriptor tuple, distance tuple) results.
    """
    # The flat lists are arguments, so each is freed inside its span.
    with trace_span("results.fetch"):
        good = rows >= 0
        counts = good.sum(axis=1)
        flat_elems = _fetch_by_uid(
            descriptor_set, [row2uid[i] for i in rows[good].tolist()])
    with trace_span("results.regroup"):
        return _regroup(rows.shape[0], counts, flat_elems,
                        dists[good].tolist())


def _fetch_by_uid(descriptor_set, flat_uids: list) -> list:
    """Fetch descriptors for ``flat_uids`` (duplicates allowed) without
    assuming the set's ``get_many_descriptors`` preserves input order or
    duplicates: unique UIDs are fetched once and re-expanded through each
    element's own ``uuid()`` — safe for dedup/set-ordered backends."""
    uniq = list(dict.fromkeys(flat_uids))
    by_uid = {e.uuid(): e
              for e in descriptor_set.get_many_descriptors(uniq)}
    return [by_uid[u] for u in flat_uids]


def assemble_results_from_uids(dists: np.ndarray,
                               uid_lists: Sequence[Sequence[Hashable]],
                               descriptor_set) -> List[NNResult]:
    """
    Variant for callers whose store already mapped rows to per-query UID
    lists (``VectorStore.knn``). ``uid_lists[i]`` aligns with the first
    ``len(uid_lists[i])`` entries of ``dists[i]``.
    """
    with trace_span("results.fetch"):
        counts = np.array([len(u) for u in uid_lists], dtype=np.int64)
        flat_elems = _fetch_by_uid(
            descriptor_set, [u for ul in uid_lists for u in ul])
    with trace_span("results.regroup"):
        return _regroup(len(uid_lists), counts, flat_elems,
                        [x for row, c in zip(dists.tolist(), counts)
                         for x in row[:c]])


def _regroup(b: int, counts: np.ndarray, flat_elems: list,
             flat_dists: list) -> List[NNResult]:
    bounds = np.concatenate([[0], np.cumsum(counts)])
    out: List[NNResult] = []
    for bi in range(b):
        lo, hi = int(bounds[bi]), int(bounds[bi + 1])
        out.append((tuple(flat_elems[lo:hi]),
                    tuple(flat_dists[lo:hi])))
    return out
