"""
Exhaustive (flat) nearest-neighbour index on a CUDA device.

Port of ``smqtk_indexing_tpu/models/nn_index/flat.py:45-372``: the same
constructor, JSON configuration, persistence payload and interface
contract, plus a ``device`` parameter. The descriptor matrix lives on the
device in ``ops/store.VectorStore``; a query batch runs the fused exact
scan (``ops/fused_scan.py``: the hand-written stage-1 kernel, then an
exact re-rank) for euclidean / inner_product / cosine, and the streamed
scan (``ops/scan.py``) for hik / chi_square. The compressed codecs
('sq8', 'pq<M>', 'opq<M>') scan their codes (``ops/sq8.sq8_topk``, with
the int8 form of the stage-1 kernel; ``ops/pq.pq_topk``) and re-rank
exactly with respect to the quantized vectors.

Select it in configuration by its fully-qualified key,
``"smqtk_indexing_tpu_torch.models.nn_index.flat.FlatNearestNeighborsIndex"``:
the bare class name is shared with the JAX package's index.

Example, on the CPU::

    index = FlatNearestNeighborsIndex(metric="euclidean", device="cpu")
    index.build_index(elements)
    neighbours, dists = index.nn(elements[0], 10)
"""
from __future__ import annotations

import json
import logging
import threading
import warnings
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np

from smqtk_indexing_tpu_torch.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataElement
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorElement, DescriptorMemoryElement, DescriptorSet,
    MemoryDescriptorSet, stack_vectors,
)
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.data.key_value import KeyValueStore
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu_torch.models.nn_index._kvs import sync_uid_kvs
from smqtk_indexing_tpu_torch.models.nn_index._results import (
    assemble_results_from_uids,
)
from smqtk_indexing_tpu_torch.ops.device import device_report
from smqtk_indexing_tpu_torch.ops.pq import PQ_METRICS, pq_m, pq_rotate
from smqtk_indexing_tpu_torch.ops.scan import METRICS
from smqtk_indexing_tpu_torch.ops.store import (
    HostStreamedVectorStore, VectorStore,
)
from smqtk_indexing_tpu_torch.parallel.mesh import (
    device_config, mesh_for, primary_device,
)
from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS, trace_span

LOG = logging.getLogger(__name__)


class FlatNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Brute-force exact kNN over a device-resident descriptor matrix.

    :param descriptor_set: Backing descriptor element storage (defaults to a
        new in-memory set).
    :param index_element: Optional DataElement to persist index state to
        (overwritten on every mutation; auto-loaded at construction). The
        payload is the JAX package's: either package loads the other's.
    :param metric: One of 'euclidean' | 'inner_product' | 'cosine' | 'hik'
        | 'chi_square'.
    :param dtype: Device storage codec: 'float32' (exact), 'bfloat16'
        (half the memory traffic), 'sq8' (one int8 code a dim), 'pq<M>'
        (product quantization, M bytes a vector) or 'opq<M>' (PQ behind a
        learned OPQ rotation; not with 'hik'). The compressed codecs serve
        'euclidean', 'inner_product', 'cosine' and 'hik'.
    :param read_only: Refuse mutations when True.
    :param n_devices: Row-shard the database across this many devices (a
        power of two); each query runs the per-shard exact scan and the
        k-sized merge (``parallel/sharded_scan.py``). None or 1: one
        device.
    :param storage: 'device' (the rows live on the device) or
        'host_stream' (the rows live in host memory only and stream
        through one device a query batch, float32 / bfloat16 only:
        ``ops/store.HostStreamedVectorStore``).
    :param device: torch device holding the index: 'cuda' (default; raises
        when no card is present) or 'cpu' (the plain PyTorch versions of
        the kernels). With ``n_devices=n``: 'cuda' is cards 0 .. n-1 (too
        few raise), 'cpu' n CPU shards, and a list of n device strings
        places each shard (a card may repeat).
    """

    # is_usable() keeps the default True: this module imports torch, so
    # the class exists only where torch imports. HOW it runs (CUDA kernels
    # or their plain CPU versions) is in usability_report().

    @classmethod
    def usability_report(cls) -> dict:
        r = super().usability_report()
        # The JAX index's switches (flat.py:99-104): a set one is listed
        # and marks the index degraded.
        r.update(device_report("cuda", flags=(
            "SMQTK_TPU_NO_FUSED", "SMQTK_TPU_NO_NATIVE")))
        return r

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["descriptor_set"] = make_default_config(DescriptorSet.get_impls())
        c["index_element"] = make_default_config(DataElement.get_impls())
        c["uid2idx_kvs"] = make_default_config(KeyValueStore.get_impls())
        c["idx2uid_kvs"] = make_default_config(KeyValueStore.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "FlatNearestNeighborsIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        slots = (("descriptor_set", DescriptorSet),
                 ("index_element", DataElement),
                 ("uid2idx_kvs", KeyValueStore),
                 ("idx2uid_kvs", KeyValueStore))
        for slot, iface in slots:
            sc = cfg.get(slot)
            if sc and sc.get("type"):
                cfg[slot] = from_config_dict(sc, iface.get_impls())
            else:
                cfg[slot] = None
        return super().from_config(cfg, False)

    def __init__(
        self,
        descriptor_set: Optional[DescriptorSet] = None,
        index_element: Optional[DataElement] = None,
        metric: str = "euclidean",
        dtype: str = "float32",
        read_only: bool = False,
        n_devices: Optional[int] = None,
        storage: str = "device",
        uid2idx_kvs=None,
        idx2uid_kvs=None,
        device: str = "cuda",
    ):
        super().__init__()
        if metric not in METRICS:
            raise ValueError(
                f"metric must be one of {METRICS}, got {metric!r}")
        if storage not in ("device", "host_stream"):
            raise ValueError(f"storage must be 'device' or 'host_stream', "
                             f"got {storage!r}")
        if storage == "host_stream" and n_devices is not None \
                and n_devices > 1:
            raise ValueError(
                "storage='host_stream' streams through one device; "
                "combine capacity axes via n_devices OR host streaming, "
                "not both.")
        if pq_rotate(dtype) and metric == "hik":
            raise ValueError(
                "metric 'hik' is not supported with OPQ dtypes (min() is "
                "rotation-variant); use 'pq<M>'")
        if metric not in PQ_METRICS \
                and (dtype == "sq8" or pq_m(dtype) is not None):
            # Fail at construction, not at the first query after a build:
            # the compressed scans serve the matmul-form metrics and hik.
            raise ValueError(
                f"metric {metric!r} is not supported with compressed "
                f"dtype {dtype!r}; use float32/bfloat16")
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.index_element = index_element
        self.metric = metric
        self.dtype = dtype
        self.read_only = bool(read_only)
        self.n_devices = n_devices
        self.storage = storage
        self.device = device_config(device)
        self._mesh = mesh_for(n_devices, device)
        # Optional external uid<->idx mirrors (see _kvs.py).
        self.uid2idx_kvs = uid2idx_kvs
        self.idx2uid_kvs = idx2uid_kvs

        self._model_lock = threading.RLock()
        self._store = self._new_store()
        self._load_index()

    def _new_store(self) -> VectorStore:
        if self.storage == "host_stream":
            return HostStreamedVectorStore(
                dtype=self.dtype, device=primary_device(self.device))
        return VectorStore(dtype=self.dtype, mesh=self._mesh,
                           device=primary_device(self.device))

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        c["metric"] = self.metric
        c["dtype"] = self.dtype
        c["read_only"] = self.read_only
        c["n_devices"] = self.n_devices
        c["storage"] = self.storage
        c["device"] = self.device
        if self.uid2idx_kvs is not None:
            c["uid2idx_kvs"] = merge_dict(
                c["uid2idx_kvs"], to_config_dict(self.uid2idx_kvs))
        if self.idx2uid_kvs is not None:
            c["idx2uid_kvs"] = merge_dict(
                c["idx2uid_kvs"], to_config_dict(self.idx2uid_kvs))
        return c

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _save_index(self) -> None:
        if self.index_element is None:
            return
        if self.index_element.is_read_only():
            raise ReadOnlyError(
                f"Index element {self.index_element} is read-only.")
        header = json.dumps({"metric": self.metric,
                             "dtype": self.dtype}).encode()
        body = self._store.to_bytes()
        payload = len(header).to_bytes(8, "big") + header + body
        self.index_element.set_bytes(payload)
        LOG.debug("Persisted flat index (%d bytes).", len(payload))

    def _load_index(self) -> None:
        if self.index_element is None or self.index_element.is_empty():
            return
        payload = self.index_element.get_bytes()
        hlen = int.from_bytes(payload[:8], "big")
        header = json.loads(payload[8:8 + hlen].decode())
        self._store.from_bytes(payload[8 + hlen:])
        # Rebuild the descriptor-set side if it disagrees with the payload.
        if self.descriptor_set.count() != self._store.n_valid:
            LOG.warning(
                "Descriptor set size (%d) disagrees with loaded index size "
                "(%d); repopulating descriptor set from index payload.",
                self.descriptor_set.count(), self._store.n_valid)
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(
                DescriptorMemoryElement(u, self._store.vector(u))
                for u in self._store.uids()
            )
        if header.get("metric") != self.metric:
            LOG.warning(
                "Loaded index was built with metric %r; instance configured "
                "with %r.", header.get("metric"), self.metric)
        if header.get("dtype") != self.dtype:
            LOG.warning(
                "Loaded index was built with dtype %r; instance configured "
                "with %r (rows re-encode with the configured codec).",
                header.get("dtype"), self.dtype)
        self._sync_kvs()

    # ------------------------------------------------------------------
    # index mutation
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._store.n_valid

    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _sync_kvs(self) -> None:
        self._kvs_synced = sync_uid_kvs(
            self.uid2idx_kvs, self.idx2uid_kvs, self._store.uid_to_row(),
            prev=getattr(self, "_kvs_synced", None))

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            # Last occurrence of a duplicated UID wins (dict semantics).
            by_uid = {e.uuid(): e for e in descriptors}
            uids = list(by_uid.keys())
            mat = stack_vectors([by_uid[u] for u in uids])
            new_store = self._new_store()
            new_store.build(mat, uids)
            # Swap once the device tensors are ready.
            self._store = new_store
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(by_uid.values())
            self._sync_kvs()
            self._save_index()

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            by_uid = {e.uuid(): e for e in descriptors}
            fresh = [u for u in by_uid if not self._store.has_uid(u)]
            skipped = len(by_uid) - len(fresh)
            if skipped:
                # Reference semantics: already-indexed UIDs are skipped
                # with a warning.
                warnings.warn(
                    f"Skipped {skipped} already-indexed descriptor UID(s) "
                    "during update.")
            if fresh:
                mat = stack_vectors([by_uid[u] for u in fresh])
                self._store.add(mat, fresh)
                self.descriptor_set.add_many_descriptors(
                    by_uid[u] for u in fresh)
            self._sync_kvs()
            self._save_index()

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        with self._model_lock:
            self._guard_read_only()
            uids = list(uids)
            # KeyError (with no mutation) surfaces from the store pre-check.
            self._store.remove(uids)
            self.descriptor_set.remove_many_descriptors(uids)
            self._sync_kvs()
            self._save_index()

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        return self._nn_many([d], n)[0]

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        with trace_span("flat.stack"):
            q = np.vstack([d.vector() for d in ds]).astype(np.float32)
        with self._model_lock, trace_span("flat.query"):
            COUNTERS.add("flat.queries", len(ds))
            dists, uid_lists, _ = self._store.knn(q, n, metric=self.metric)
            with trace_span("flat.assemble"):
                out = assemble_results_from_uids(dists, uid_lists,
                                                 self.descriptor_set)
        shortest = min((len(o[0]) for o in out), default=n)
        if shortest < n:
            warnings.warn(
                f"Requested {n} neighbors but only {shortest} are indexed.")
        return out
