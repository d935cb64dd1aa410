"""
Composite LSH nearest-neighbour index on a CUDA device: the port of
``smqtk_indexing_tpu/models/nn_index/lsh.py``.

Capability-parity with the reference's ``LSHNearestNeighborIndex``
(SMQTK-Indexing smqtk_indexing/impls/nn_index/lsh.py:39-519): an
``LshFunctor`` maps descriptors to hash codes, a ``hash2uuids`` KV store maps
code integers to UID sets, an optional ``HashIndex`` serves near-code
lookup (with a cached LinearHashIndex over the KV keys as fallback,
lsh.py:481-487), and candidates are re-ranked by exact distance.

Two query paths, as in the JAX index:

- the single-call fused serve (``ops/lsh_fused.lsh_fused_query``) over a
  device-resident bucket table, when no ``hash_index`` is configured, the
  functor has an affine form (``hash_model``) and the padded candidate
  budget holds; its near-code engine is ``"mxu"`` (K1's bf16 form on the
  ±1 code table) from ``MXU_SCAN_MIN`` unique codes on, or under
  ``SMQTK_TPU_LSH_FUSED_MXU``, else ``"xor"``;
- the two-call path (hash, the hash index's ``nn_many``, a host bucket
  expansion, one batched exact re-rank on the device), under
  ``SMQTK_TPU_NO_LSH_FUSED`` or where the fused serve is not eligible.

Both switches are read per query.
"""
from __future__ import annotations

import logging
import math
import os
import threading
from typing import (
    Any, Dict, Hashable, Iterable, List, Optional, Sequence, Set, Tuple,
)

import numpy as np
import torch

from smqtk_indexing_tpu_torch.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorElement, DescriptorSet, MemoryDescriptorSet,
)
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.data.key_value import (
    KeyValueStore, MemoryKeyValueStore,
)
from smqtk_indexing_tpu_torch.interfaces.hash_index import HashIndex
from smqtk_indexing_tpu_torch.interfaces.lsh_functor import LshFunctor
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu_torch.models.hash_index.linear import LinearHashIndex
from smqtk_indexing_tpu_torch.ops.device import (
    device_report, pow2_at_least as _pow2_at_least, round_up,
)
from smqtk_indexing_tpu_torch.ops.fused_scan import TILE_N
from smqtk_indexing_tpu_torch.ops.hamming import MXU_SCAN_MIN
from smqtk_indexing_tpu_torch.ops.lsh_fused import lsh_fused_query
from smqtk_indexing_tpu_torch.ops.metrics import candidate_distances
from smqtk_indexing_tpu_torch.utils.bits import (
    bit_matrix_to_ints, bit_vector_to_int_large, int_to_bit_vector_large,
    ints_to_packed_u32, unpack_bit_vectors_u32,
)
from smqtk_indexing_tpu_torch.parallel.mesh import (
    device_config, mesh_for, primary_device, shard_rows,
)
from smqtk_indexing_tpu_torch.parallel.sharded_scan import (
    sharded_rerank_topk,
)
from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS, trace_span

LOG = logging.getLogger(__name__)

VALID_DISTANCES = ("euclidean", "cosine", "hik")


def _rerank_batch(q: torch.Tensor, cand: torch.Tensor, valid: torch.Tensor,
                  metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched exact re-rank: (B, d) queries vs per-query (B, M, d)
    candidates, each row sorted ascending (stably, as ``jnp.argsort``) with
    invalid slots at +inf. The on-device analog of the reference's
    fetch-and-re-rank (lsh.py:507-518)."""
    d = candidate_distances(q, cand, metric)
    d = torch.where(valid, d, math.inf)
    return torch.sort(d, dim=1, stable=True)


class LSHNearestNeighborIndex (NearestNeighborsIndex):
    """
    Locality-sensitive-hashing based nearest neighbor index.

    :param lsh_functor: LSH functor mapping descriptors to hash codes.
    :param descriptor_set: Backing descriptor element storage.
    :param hash2uuids_kvstore: KV store mapping hash-code integers to sets of
        descriptor UIDs.
    :param hash_index: Optional HashIndex for near-code lookup; when None, a
        LinearHashIndex is built over the KV-store keys at query time
        (reference fallback semantics, lsh.py:481-487).
    :param distance_method: Candidate re-rank distance:
        'euclidean' | 'cosine' | 'hik'.
    :param read_only: Refuse mutations when True.
    :param n_devices: Ride a device mesh (power of two): the on-the-fly
        fallback ``LinearHashIndex`` row-shards its codes across it, and
        the exact re-rank splits each query's candidate block across it
        (``parallel/sharded_scan.sharded_rerank_topk``). The fused serve
        is single-device, so it is off. A configured ``hash_index`` keeps
        its own placement. None or 1: one device.
    :param device: torch device of the bucket table, the re-rank and the
        fallback hash index: 'cuda' (default; raises when no card is
        present) or 'cpu'. The functor and a configured ``hash_index``
        keep their own. With ``n_devices=n``: 'cuda' is cards 0 .. n-1,
        'cpu' n CPU shards, and a list of n device strings places each
        shard.

    >>> import numpy as np
    >>> from smqtk_indexing_tpu_torch.data.descriptor import (
    ...     DescriptorMemoryElement)
    >>> from smqtk_indexing_tpu_torch.models.lsh_functor.itq import (
    ...     ItqFunctor)
    >>> rng = np.random.default_rng(0)
    >>> els = [DescriptorMemoryElement(i, rng.normal(size=16)
    ...        .astype(np.float32)) for i in range(64)]
    >>> functor = ItqFunctor(bit_length=8, random_seed=0, device="cpu")
    >>> functor.fit(els)
    >>> index = LSHNearestNeighborIndex(lsh_functor=functor, device="cpu")
    >>> index.build_index(els)
    >>> neighbors, dists = index.nn(els[7], 3)
    >>> neighbors[0].uuid()
    7
    """

    # is_usable() keeps the default True: this module imports torch, so
    # the class exists only where torch imports. HOW it runs (CUDA kernels
    # or their plain CPU versions) is in usability_report().

    @classmethod
    def usability_report(cls) -> dict:
        r = super().usability_report()
        # The JAX index's switches (lsh.py:133-139) and the fused serve's
        # own two: a set one is listed and marks the index degraded.
        r.update(device_report("cuda", flags=(
            "SMQTK_TPU_NO_MXU_HAMMING", "SMQTK_TPU_NO_NATIVE",
            "SMQTK_TPU_NO_LSH_FUSED", "SMQTK_TPU_LSH_FUSED_MXU")))
        return r

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["lsh_functor"] = make_default_config(LshFunctor.get_impls())
        c["descriptor_set"] = make_default_config(DescriptorSet.get_impls())
        c["hash2uuids_kvstore"] = make_default_config(
            KeyValueStore.get_impls())
        c["hash_index"] = make_default_config(HashIndex.get_impls())
        # Match the reference's nullable sub-config for the optional hash
        # index (lsh.py:141-148).
        c["hash_index"]["type"] = None
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "LSHNearestNeighborIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        cfg["lsh_functor"] = from_config_dict(
            cfg["lsh_functor"], LshFunctor.get_impls())
        ds_cfg = cfg.get("descriptor_set")
        if ds_cfg and ds_cfg.get("type"):
            cfg["descriptor_set"] = from_config_dict(
                ds_cfg, DescriptorSet.get_impls())
        else:
            cfg["descriptor_set"] = MemoryDescriptorSet()
        kv_cfg = cfg.get("hash2uuids_kvstore")
        if kv_cfg and kv_cfg.get("type"):
            cfg["hash2uuids_kvstore"] = from_config_dict(
                kv_cfg, KeyValueStore.get_impls())
        else:
            cfg["hash2uuids_kvstore"] = MemoryKeyValueStore()
        hi_cfg = cfg.get("hash_index")
        if hi_cfg and hi_cfg.get("type"):
            cfg["hash_index"] = from_config_dict(
                hi_cfg, HashIndex.get_impls())
        else:
            cfg["hash_index"] = None
        return super().from_config(cfg, False)

    def __init__(self,
                 lsh_functor: LshFunctor,
                 descriptor_set: Optional[DescriptorSet] = None,
                 hash2uuids_kvstore: Optional[KeyValueStore] = None,
                 hash_index: Optional[HashIndex] = None,
                 distance_method: str = "cosine",
                 read_only: bool = False,
                 n_devices: Optional[int] = None,
                 device: str = "cuda"):
        super().__init__()
        if distance_method not in VALID_DISTANCES:
            raise ValueError(
                f"distance_method must be one of {VALID_DISTANCES}, got "
                f"{distance_method!r}")
        self.lsh_functor = lsh_functor
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.hash2uuids_kvstore = hash2uuids_kvstore \
            if hash2uuids_kvstore is not None else MemoryKeyValueStore()
        self.hash_index = hash_index
        self.distance_method = distance_method
        self.read_only = bool(read_only)
        self.n_devices = n_devices
        self.device = device_config(device)
        self._device = primary_device(device)
        self._mesh = mesh_for(n_devices, device)
        self._model_lock = threading.RLock()
        # Cached on-the-fly fallback hash index (the reference rebuilds it
        # on EVERY query, lsh.py:481-487 — an O(N) host pass per lookup;
        # here it is invalidated only when the KV mapping mutates).
        self._fallback_hi: Optional[LinearHashIndex] = None
        # Cached device-resident bucket state for the SINGLE-DISPATCH
        # serving program (ops/lsh_fused.py) — hash + near-code scan +
        # bucket expand + exact re-rank in one device round trip instead
        # of two with a host hop between (round 5; invalidated with the
        # fallback on every mutation).
        self._fused: Optional[dict] = None

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["lsh_functor"] = merge_dict(
            c["lsh_functor"], to_config_dict(self.lsh_functor))
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        c["hash2uuids_kvstore"] = merge_dict(
            c["hash2uuids_kvstore"],
            to_config_dict(self.hash2uuids_kvstore))
        if self.hash_index is not None:
            c["hash_index"] = merge_dict(
                c["hash_index"], to_config_dict(self.hash_index))
        else:
            c["hash_index"]["type"] = None
        c["distance_method"] = self.distance_method
        c["read_only"] = self.read_only
        c["n_devices"] = self.n_devices
        c["device"] = self.device
        return c

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _hash_elements(
            self, elems: Sequence[DescriptorElement]
    ) -> Tuple[np.ndarray, List[int]]:
        """Batched hash of elements -> ((n, bits) bool matrix, code ints)."""
        mat = np.vstack([e.vector() for e in elems]).astype(np.float32)
        codes = self.lsh_functor.get_hash_batch(mat)
        ints = bit_matrix_to_ints(codes)
        return codes, ints

    def count(self) -> int:
        # Σ |uid-set| over the KV store (reference lsh.py:271-281).
        with self._model_lock:
            return sum(len(v) for v in self.hash2uuids_kvstore.values())

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            LOG.debug("Building LSH index over %d descriptors (one batched "
                      "hash program)", len(elems))
            codes, ints = self._hash_elements(elems)

            kv_update: Dict[int, Set[Hashable]] = {}
            for e, c in zip(elems, ints):
                kv_update.setdefault(c, set()).add(e.uuid())

            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(elems)
            self.hash2uuids_kvstore.clear()
            self.hash2uuids_kvstore.add_many(kv_update)
            self._fallback_hi = None
            self._fused = None

            if self.hash_index is not None:
                # Unique codes only (HashIndex contract).
                uniq_rows: Dict[int, int] = {}
                for i, c in enumerate(ints):
                    uniq_rows.setdefault(c, i)
                self.hash_index.build_index(
                    codes[sorted(uniq_rows.values())])

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            codes, ints = self._hash_elements(elems)

            new_code_rows: List[int] = []
            kv_update: Dict[int, Set[Hashable]] = {}
            for i, (e, c) in enumerate(zip(elems, ints)):
                if c in kv_update:
                    s = kv_update[c]
                else:
                    s = set(self.hash2uuids_kvstore.get(c, set()))
                    if not s:
                        new_code_rows.append(i)
                    kv_update[c] = s
                s.add(e.uuid())

            self.descriptor_set.add_many_descriptors(elems)
            self.hash2uuids_kvstore.add_many(kv_update)
            self._fallback_hi = None
            self._fused = None
            if self.hash_index is not None and new_code_rows:
                self.hash_index.update_index(codes[new_code_rows])

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        """
        Remove descriptors by UID, pruning per-hash UID sets and deleting
        emptied hash codes from the KV store and hash index (reference
        lsh.py:385-450), with the KeyError-no-mutation guarantee.
        """
        with self._model_lock:
            self._guard_read_only()
            uids = list(uids)
            # Pre-check: all UIDs must exist (raises KeyError before any
            # mutation; MemoryDescriptorSet.get_many_descriptors checks
            # before yielding). Re-pair by uuid — the zip with ``uids``
            # below is positional and get_many_descriptors order is not
            # guaranteed (same defense as models/nn_index/_results.py).
            fetched = {e.uuid(): e for e in
                       self.descriptor_set.get_many_descriptors(uids)}
            elems = [fetched[u] for u in uids]
            codes, ints = self._hash_elements(elems)

            kv_update: Dict[int, Set[Hashable]] = {}
            kv_delete: Set[int] = set()
            dead_code_rows: List[int] = []
            for i, (u, c) in enumerate(zip(uids, ints)):
                if c in kv_update:
                    s = kv_update[c]
                else:
                    s = set(self.hash2uuids_kvstore.get(c, set()))
                    kv_update[c] = s
                s.discard(u)
                if not s:
                    kv_delete.add(c)
                    dead_code_rows.append(i)
            for c in kv_delete:
                kv_update.pop(c, None)

            if kv_update:
                self.hash2uuids_kvstore.add_many(kv_update)
            if kv_delete:
                self.hash2uuids_kvstore.remove_many(kv_delete)
            self._fallback_hi = None
            self._fused = None
            if self.hash_index is not None and dead_code_rows:
                self.hash_index.remove_from_index(codes[dead_code_rows])
            self.descriptor_set.remove_many_descriptors(uids)

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def _choose_hash_index(self, bits: int) -> HashIndex:
        """Configured hash index, or a (mutation-invalidated) cached linear
        index over the KV store's code keys (reference on-the-fly
        semantics, lsh.py:481-487, without the per-query rebuild)."""
        if self.hash_index is not None:
            return self.hash_index
        if self._fallback_hi is None:
            hi = LinearHashIndex(n_devices=self.n_devices,
                                 device=self.device)
            keys = list(self.hash2uuids_kvstore.keys())
            hi.build_index(
                np.vstack([int_to_bit_vector_large(c, bits) for c in keys]))
            self._fallback_hi = hi
        return self._fallback_hi

    #: Candidate-slot budget for the fused serve: B x n_codes x l_max
    #: gathered rows per call. Beyond this the padded gather's memory and
    #: work outgrow the saved round trip (degenerate all-rows-in-one-bucket
    #: distributions land here): serve through the two-call path instead.
    _FUSED_SLOT_BUDGET = 1 << 24

    def _fused_ready(self, n: int, b: int) -> Optional[dict]:
        """Device-resident bucket state for the single-call fused serve
        (``ops/lsh_fused.py``), or None when ineligible.

        Eligible when: no configured ``hash_index`` (the fused near-code
        scan IS the on-the-fly-linear fallback semantics, reference
        lsh.py:481-487), one device, the functor exposes its affine form
        (``LshFunctor.hash_model``), and the padded candidate budget is
        sane. SMQTK_TPU_NO_LSH_FUSED=1 opts out (A/B against the two-call
        path). The near-code engine is "mxu" (the ±1 bf16 code table,
        K1's bf16 form) from ``MXU_SCAN_MIN`` unique codes on or under
        SMQTK_TPU_LSH_FUSED_MXU=1, else "xor"."""
        if os.environ.get("SMQTK_TPU_NO_LSH_FUSED") \
                or self.hash_index is not None \
                or self._mesh is not None:
            return None
        model = self.lsh_functor.hash_model()
        if model is None:
            return None
        if self._fused is None:
            keys = list(self.hash2uuids_kvstore.keys())
            if not keys:
                return None
            self._fused = self._fused_state(keys, model)
        st = self._fused
        n_codes = _pow2_at_least(min(n, st["n_codes_live"]), lo=1)
        # Budget against the PADDED batch the serve runs (_nn_many_fused
        # pads b to a power of two, floor 8).
        if _pow2_at_least(b, lo=8) * n_codes * st["l_max"] \
                > self._FUSED_SLOT_BUDGET:
            return None
        return st

    def _fused_state(self, keys: List[int], model) -> dict:
        """The bucket-sorted layout and code table of ``_fused_ready``."""
        mean, proj, normalize = model
        bits = proj.shape[1]
        u = len(keys)
        mxu_want = u >= MXU_SCAN_MIN \
            or bool(os.environ.get("SMQTK_TPU_LSH_FUSED_MXU"))
        # The "mxu" engine's scan needs the code table padded to the
        # kernel's tile (dead codes are +inf-masked either way).
        u_pad = _pow2_at_least(u, lo=TILE_N if mxu_want else 8)
        packed = np.zeros((u_pad, (bits + 31) // 32), dtype=np.uint32)
        packed[:u] = ints_to_packed_u32(keys, bits)
        code_valid = np.zeros(u_pad, dtype=bool)
        code_valid[:u] = True
        # Bucket-sorted row layout (the IVF list-sorted trick): each
        # unique code's members contiguous, so expansion is a CSR window,
        # with no host hop to look UIDs up per query.
        off = np.zeros(u_pad, dtype=np.int64)
        ln = np.zeros(u_pad, dtype=np.int64)
        uids: List[Hashable] = []
        for i, c in enumerate(keys):
            members = list(self.hash2uuids_kvstore.get(c))
            off[i] = len(uids)
            ln[i] = len(members)
            uids.extend(members)
        # Re-pair by uuid: the CSR off/len windows are positional over
        # ``uids`` and get_many_descriptors order is not guaranteed
        # (dedup/set-ordered DescriptorSet backends) — same defense as
        # models/nn_index/_results.py.
        fetched = {e.uuid(): e for e in
                   self.descriptor_set.get_many_descriptors(uids)}
        elems = [fetched[x] for x in uids]
        n_rows = len(elems)
        d_dim = int(np.asarray(elems[0].vector()).shape[-1]) \
            if n_rows else proj.shape[0]
        n_pad = _pow2_at_least(max(n_rows, 1), lo=8)
        mat = np.zeros((n_pad, d_dim), dtype=np.float32)
        if n_rows:
            mat[:n_rows] = np.vstack([e.vector() for e in elems])
        row_valid = np.zeros(n_pad, dtype=bool)
        row_valid[:n_rows] = True
        dev = self._device

        def put(a):
            return torch.from_numpy(a).to(dev)
        pm1 = code_sq = None
        if mxu_want:
            # The ±1 bf16 code table of the "mxu" engine, bits padded to
            # a multiple of 128; no transposed copy (the port's stage 1
            # scans the row-major table).
            pm1_np = np.zeros((u_pad, round_up(bits, 128)),
                              dtype=np.float32)
            pm1_np[:u, :bits] = unpack_bit_vectors_u32(
                packed[:u], bits).astype(np.float32) * 2.0 - 1.0
            pm1 = put(pm1_np).to(torch.bfloat16)
            code_sq = put(np.where(code_valid, float(bits), 0.0)
                          .astype(np.float32))
        return {
            "db": put(mat),
            "row_valid": put(row_valid),
            "packed": put(packed.view(np.int32)),
            "code_valid": put(code_valid),
            "off": put(off),
            "ln": put(ln),
            "mean": put(np.asarray(mean, dtype=np.float32)),
            "proj": put(np.ascontiguousarray(proj, dtype=np.float32)),
            "normalize": normalize,
            "l_max": _pow2_at_least(max(int(ln.max()), 1), lo=1),
            "n_codes_live": u,
            "row2elem": elems,
            "pm1": pm1,
            "code_sq": code_sq,
        }

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        """
        Batched query: one hashing product for all queries, one batched
        near-code scan, one padded re-rank on the device (the reference
        processes queries one at a time end to end).
        """
        with self._model_lock, trace_span("lsh.query_batch"):
            q_mat = np.vstack([d.vector() for d in ds]).astype(np.float32)
            st = self._fused_ready(n, len(ds))
            if st is not None:
                return self._nn_many_fused(st, q_mat, n)
            q_codes = self.lsh_functor.get_hash_batch(q_mat)
            bits = q_codes.shape[1]
            hi = self._choose_hash_index(bits)
            near_per_q = hi.nn_many(q_codes, n)

            cand_uids_per_q: List[List[Hashable]] = []
            for near_codes, _ in near_per_q:
                cand_uids: List[Hashable] = []
                seen: Set[Hashable] = set()
                for code in near_codes:
                    c_int = bit_vector_to_int_large(code)
                    for u in self.hash2uuids_kvstore.get(c_int, set()):
                        if u not in seen:
                            seen.add(u)
                            cand_uids.append(u)
                cand_uids_per_q.append(cand_uids)
            # ONE storage fetch for the whole batch, regrouped per query.
            flat_elems = list(self.descriptor_set.get_many_descriptors(
                [u for ul in cand_uids_per_q for u in ul]))
            cand_elems_per_q = []
            pos = 0
            for ul in cand_uids_per_q:
                cand_elems_per_q.append(flat_elems[pos:pos + len(ul)])
                pos += len(ul)
            COUNTERS.add("lsh.queries", len(ds))
            COUNTERS.add("lsh.candidates",
                         sum(len(c) for c in cand_elems_per_q))

            d_dim = q_mat.shape[1]
            mesh = self._mesh
            m_pad = _pow2_at_least(
                max(len(c) for c in cand_elems_per_q),
                lo=max(8, mesh.size if mesh is not None else 8))
            cand = np.zeros((len(ds), m_pad, d_dim), dtype=np.float32)
            valid = np.zeros((len(ds), m_pad), dtype=bool)
            for i, elems in enumerate(cand_elems_per_q):
                if elems:
                    cand[i, :len(elems)] = np.vstack(
                        [e.vector() for e in elems])
                    valid[i, :len(elems)] = True
            if mesh is not None:
                # The candidate block splits on its M axis (lsh.py:547-575).
                dists, order = sharded_rerank_topk(
                    mesh, q_mat, shard_rows(mesh, cand, axis=1),
                    shard_rows(mesh, valid, axis=1),
                    k=min(_pow2_at_least(n, lo=1), m_pad),
                    metric=self.distance_method)
            else:
                dev = self._device
                dists, order = _rerank_batch(
                    torch.from_numpy(q_mat).to(dev),
                    torch.from_numpy(cand).to(dev),
                    torch.from_numpy(valid).to(dev), self.distance_method)
            dists = dists.cpu().numpy()
            order = order.cpu().numpy()

        out: List[NNResult] = []
        for i, elems in enumerate(cand_elems_per_q):
            k = min(n, len(elems))
            out.append((tuple(elems[j] for j in order[i, :k]),
                        tuple(float(x) for x in dists[i, :k])))
        return out

    def _nn_many_fused(self, st: dict, q_mat: np.ndarray, n: int
                       ) -> List[NNResult]:
        """Serve a batch through the single-call fused serve: hash +
        near-code Hamming top-n + bucket-window expansion + exact re-rank
        (``ops/lsh_fused.py``), with no host hop between them (reference
        flow lsh.py:452-518)."""
        b = q_mat.shape[0]
        q_p = np.zeros((_pow2_at_least(b, lo=8), q_mat.shape[1]),
                       dtype=np.float32)
        q_p[:b] = q_mat
        n_sel = min(n, st["n_codes_live"])
        n_rows = len(st["row2elem"])
        k_dev = _pow2_at_least(min(n, max(n_rows, 1)), lo=1)
        COUNTERS.add("lsh.queries", b)
        COUNTERS.add("lsh.fused_queries", b)
        dists, rows = lsh_fused_query(
            st["db"], st["row_valid"], st["packed"], st["code_valid"],
            st["off"], st["ln"], torch.from_numpy(q_p).to(st["db"].device),
            st["mean"], st["proj"], k=k_dev,
            n_codes=_pow2_at_least(n_sel, lo=1), n_sel=n_sel,
            l_max=st["l_max"], metric=self.distance_method,
            normalize=st["normalize"],
            engine="mxu" if st["pm1"] is not None else "xor",
            pm1=st["pm1"], code_sq=st["code_sq"])
        dists = dists[:b].cpu().numpy()
        rows = rows[:b].cpu().numpy()
        elems = st["row2elem"]
        out: List[NNResult] = []
        for i in range(b):
            k = min(n, int((rows[i] >= 0).sum()))
            out.append((tuple(elems[r] for r in rows[i, :k]),
                        tuple(float(x) for x in dists[i, :k])))
        return out

    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        with self._model_lock:
            q_vec = np.asarray(d.vector(), dtype=np.float32)
            st = self._fused_ready(n, 1)
            if st is not None:
                return self._nn_many_fused(
                    st, np.atleast_2d(q_vec), n)[0]
            q_code = self.lsh_functor.get_hash(q_vec)
            bits = len(q_code)
            hi = self._choose_hash_index(bits)
            near_codes, _ = hi.nn(q_code, n)

            cand_uids: List[Hashable] = []
            seen: Set[Hashable] = set()
            for code in near_codes:
                c_int = bit_vector_to_int_large(code)
                for u in self.hash2uuids_kvstore.get(c_int, set()):
                    if u not in seen:
                        seen.add(u)
                        cand_uids.append(u)
            LOG.debug("Query: %d near codes -> %d candidate UIDs",
                      len(near_codes), len(cand_uids))
            COUNTERS.add("lsh.queries")
            COUNTERS.add("lsh.candidates", len(cand_uids))

            cand_elems = list(
                self.descriptor_set.get_many_descriptors(cand_uids))
            if not cand_elems:
                # Configured hash index out of sync with the KV mapping
                # (e.g. stale persisted cache): no candidates.
                return ((), ())
            cand = np.vstack([e.vector() for e in cand_elems]) \
                .astype(np.float32)

        m = cand.shape[0]
        m_pad = _pow2_at_least(m, lo=8)
        pad = np.zeros((1, m_pad, cand.shape[1]), dtype=np.float32)
        pad[0, :m] = cand
        valid = np.zeros((1, m_pad), dtype=bool)
        valid[0, :m] = True
        dev = self._device
        dists, order = _rerank_batch(
            torch.from_numpy(q_vec[None, :]).to(dev),
            torch.from_numpy(pad).to(dev), torch.from_numpy(valid).to(dev),
            self.distance_method)
        k = min(n, m)
        dists = dists[0, :k].cpu().numpy()
        order = order[0, :k].cpu().numpy()
        return (tuple(cand_elems[i] for i in order),
                tuple(float(x) for x in dists))
