"""
Optional external uid<->index KeyValueStore mirrors.

A copy of ``smqtk_indexing_tpu/models/nn_index/_kvs.py`` (72 lines): that
module cannot be imported without jax, because its package ``__init__``
imports the JAX index implementations.

The reference exposes its FAISS index's uid<->idx bookkeeping as two
configurable KeyValueStore plugin slots (``uid2idx_kvs`` / ``idx2uid_kvs``,
the reference's ``faiss.py:260-274``), so
deployments persist the mapping beside (not inside) the index payload.
Here the mapping always lives inside the index payload (single-artifact
persistence); these slots are a WRITE-THROUGH MIRROR kept for config
compatibility with the reference's three-store layout and for external
inspection — the index never reads them back.

The sync is incremental: the caller passes the previously-synced mapping
back and only the delta (added / removed / re-rowed uids) is written, so
a single-element update or non-compacting removal is O(delta) external
writes rather than a full O(N) clear-and-rewrite. A full rewrite happens
only when no previous snapshot exists (first sync after construction or
load) — external edits to the mirror stores between syncs are NOT
reconciled (write-through, never read back).
"""
from __future__ import annotations

from typing import Dict, Optional


def sync_uid_kvs(uid2idx_kvs, idx2uid_kvs, uid2row: Dict,
                 prev: Optional[Dict] = None) -> Dict:
    """Mirror the live uid -> row mapping into the optional external
    stores (no-op when both are None). Called after every mutation and
    load, under the model lock, so the stores always reflect the served
    layout (rows change on compaction/rebuild — the value-diff below
    catches re-rowed uids too).

    Returns the mapping that was synced; pass it back as ``prev`` on the
    next call to sync only the delta.
    """
    if uid2idx_kvs is None and idx2uid_kvs is None:
        return uid2row
    if prev is None:
        if uid2idx_kvs is not None:
            uid2idx_kvs.clear()
            if uid2row:
                uid2idx_kvs.add_many(uid2row)
        if idx2uid_kvs is not None:
            idx2uid_kvs.clear()
            if uid2row:
                idx2uid_kvs.add_many({i: u for u, i in uid2row.items()})
        return uid2row
    gone_uids = [u for u in prev if u not in uid2row]
    changed = {u: r for u, r in uid2row.items() if prev.get(u, _MISS) != r}
    if uid2idx_kvs is not None:
        if gone_uids:
            uid2idx_kvs.remove_many(gone_uids)
        if changed:
            uid2idx_kvs.add_many(changed)
    if idx2uid_kvs is not None:
        new_rows = {r: u for u, r in uid2row.items()}
        gone_rows = [r for r in set(prev.values()) if r not in new_rows]
        changed_rows = {r: u for r, u in new_rows.items()
                        if prev.get(u, _MISS) != r}
        if gone_rows:
            idx2uid_kvs.remove_many(gone_rows)
        if changed_rows:
            idx2uid_kvs.add_many(changed_rows)
    return uid2row


class _Miss:
    __slots__ = ()


_MISS = _Miss()
