"""
Persistence of the port's ``IvfNearestNeighborsIndex``: the payload of
``smqtk_indexing_tpu/models/nn_index/_ivf_persist.py:22-168``, byte for
byte. An 8-byte big-endian header length, a JSON header (``metric``,
``storage``, ``dim``, ``pq_residual``), then an npz of the live rows
(``matrix``: float32 rows; on the code tier int8 SQ8 codes with
``code_a`` / ``code_b``, or uint8 PQ codes with ``code_cb`` and, for OPQ,
``code_rot``), ``uids``, ``centroids`` and ``assigns``. Either package
loads the other's payload, so the JAX index's trained state (centroids,
assignments, codec, residual flag) carries into the port and back. A
code payload loaded by an instance of another codec or tier decodes to
float rows first.
"""
from __future__ import annotations

import io
import json
import logging

import numpy as np

from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.ops.device import pad_rows_np
from smqtk_indexing_tpu_torch.ops.pq import pq_decode_np, pq_perm

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
                         "pq_residual": idx.pq_residual}).encode()
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
        elif idx._code_cb is not None:
            # PQ code tier: uint8 codes and codebooks (the interleave
            # follows from the padded dim), and the OPQ rotation.
            extra = {"code_cb": idx._code_cb}
            if idx._code_rot is not None:
                extra["code_rot"] = idx._code_rot
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
        mat = z["matrix"]
        uids = list(z["uids"])
        idx._centroids_np = z["centroids"]
        assigns = z["assigns"].astype(np.int32)
        code_a = z["code_a"] if "code_a" in z else None
        code_b = z["code_b"] if "code_b" in z else None
        code_cb = z["code_cb"] if "code_cb" in z else None
        code_rot = z["code_rot"] if "code_rot" in z else None
    # A PQ row is M codes wide, so the true dim comes from the header.
    pq_payload = mat.dtype == np.uint8 and code_cb is not None
    idx._dim = int(header["dim"]) if pq_payload else int(mat.shape[1])
    code_tier_pq = idx.storage == "code" and idx._pq_m(idx.dtype) is not None
    if mat.dtype == np.int8 and code_a is not None:
        if idx.storage == "code" and not code_tier_pq:
            # Codes and codec restore as they are.
            idx._code_a, idx._code_b = code_a, code_b
        else:
            # Written by an SQ8 code-tier index, loaded by another tier or
            # codec: decode (lossy only by the SQ8 step the codes carry).
            mat = mat.astype(np.float32) * code_a[None, :] + code_b[None, :]
    elif pq_payload:
        if code_tier_pq:
            # The payload defines the codec: its codebooks, rotation and
            # residual flag (absent in older payloads: raw codes).
            idx._code_cb = np.asarray(code_cb, np.float32)
            if code_rot is not None:
                idx._code_rot = np.asarray(code_rot, np.float32)
            idx.pq_residual = bool(header.get("pq_residual", False))
        else:
            mat = _decode_pq_payload(idx, mat, code_cb, code_rot, assigns,
                                     bool(header.get("pq_residual")))
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


def _decode_pq_payload(idx, codes, code_cb, code_rot, assigns,
                       residual: bool) -> np.ndarray:
    """Float rows of a PQ payload (``_ivf_persist.py:133-153``): decode,
    rotate back out of the OPQ frame, add the list centroid in residual
    mode, then undo the interleave and drop the padding dims."""
    x_c = pq_decode_np(codes, np.asarray(code_cb, np.float32))
    if code_rot is not None:
        x_c = x_c @ np.asarray(code_rot, np.float32).T
    d_codec = x_c.shape[1]
    perm = pq_perm(d_codec, code_cb.shape[0])
    if residual:
        x_c = x_c + pad_rows_np(idx._centroids_np.astype(np.float32),
                                idx._centroids_np.shape[0],
                                d_codec)[:, perm][assigns]
    return np.ascontiguousarray(x_c[:, np.argsort(perm)][:, :idx._dim])
