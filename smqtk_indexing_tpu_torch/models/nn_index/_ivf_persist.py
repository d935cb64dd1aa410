"""
Persistence of the port's ``IvfNearestNeighborsIndex``: the payload of
``smqtk_indexing_tpu/models/nn_index/_ivf_persist.py:22-168``, byte for
byte. An 8-byte big-endian header length, a JSON header (``metric``,
``storage``, ``dim``, ``pq_residual``), then an npz of the live rows
(``matrix``: float32 rows, or int8 codes with ``code_a`` / ``code_b`` on
the code tier), ``uids``, ``centroids`` and ``assigns``. Either package
loads the other's payload, so the JAX index's trained state (centroids,
assignments, codec) carries into the port and back.

PQ-code payloads (uint8 codes with ``code_cb``) raise until the codec
slice is ported.
"""
from __future__ import annotations

import io
import json
import logging

import numpy as np

from smqtk_indexing_tpu.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu.data.exceptions import ReadOnlyError

LOG = logging.getLogger("smqtk_indexing_tpu_torch.models.nn_index.ivf")


def save_index(idx) -> None:
    if idx.index_element is None:
        return
    if idx.index_element.is_read_only():
        raise ReadOnlyError(
            f"Index element {idx.index_element} is read-only.")
    header = json.dumps({"metric": idx.metric,
                         "storage": idx.storage,
                         "dim": idx._dim,
                         "pq_residual": False}).encode()
    bio = io.BytesIO()
    if idx._host is None:
        np.savez(bio, empty=np.array(True))
    else:
        keep = np.flatnonzero(idx._valid_host)
        extra = {}
        if idx._code_a is not None:
            # Code tier: the int8 codes and their codec; float rows are
            # never persisted.
            extra = {"code_a": idx._code_a, "code_b": idx._code_b}
        np.savez(bio,
                 matrix=idx._host[keep],
                 uids=np.array([idx._row2uid[i] for i in keep],
                               dtype=object),
                 centroids=idx._centroids_np,
                 assigns=idx._assign_host[keep],
                 **extra)
    idx.index_element.set_bytes(
        len(header).to_bytes(8, "big") + header + bio.getvalue())


def load_index(idx) -> None:
    if idx.index_element is None or idx.index_element.is_empty():
        return
    payload = idx.index_element.get_bytes()
    hlen = int.from_bytes(payload[:8], "big")
    header = json.loads(payload[8:8 + hlen].decode())
    if header.get("metric") != idx.metric:
        LOG.warning(
            "Loaded IVF index was built with metric %r; instance is "
            "configured with %r; centroids and layout may not suit the "
            "configured metric.", header.get("metric"), idx.metric)
    with np.load(io.BytesIO(payload[8 + hlen:]), allow_pickle=True) as z:
        if "empty" in z:
            return
        if "code_cb" in z:
            raise ValueError(
                "PQ-code IVF payloads are not ported yet: they are the "
                "'Codecs' slice of ROADMAP.md (queue 1, item 4).")
        mat = z["matrix"]
        uids = list(z["uids"])
        idx._centroids_np = z["centroids"]
        assigns = z["assigns"].astype(np.int32)
        code_a = z["code_a"] if "code_a" in z else None
        code_b = z["code_b"] if "code_b" in z else None
    idx._dim = int(mat.shape[1])
    if mat.dtype == np.int8 and code_a is not None:
        if idx.storage == "code":
            # Codes and codec restore as they are.
            idx._code_a, idx._code_b = code_a, code_b
        else:
            # Written by a code-tier index, loaded by a rows-tier one:
            # decode (lossy only by the SQ8 step the codes carry).
            mat = mat.astype(np.float32) * code_a[None, :] + code_b[None, :]
    idx._layout(mat, uids, assigns)
    if idx.descriptor_set.count() != idx._n_live:
        LOG.warning(
            "Descriptor set size (%d) disagrees with loaded index size "
            "(%d); repopulating from index payload.",
            idx.descriptor_set.count(), idx._n_live)
        idx.descriptor_set.clear()
        idx.descriptor_set.add_many_descriptors(
            DescriptorMemoryElement(idx._row2uid[i], idx._row_vector(i))
            for i in np.flatnonzero(idx._valid_host))
    idx._sync_kvs()
