"""
MRPT (Multiple Random Projection Trees) nearest-neighbour index on a CUDA
device.

Port of ``smqtk_indexing_tpu/models/nn_index/mrpt.py:46-511``: the same
constructor, JSON configuration, persisted payload (the ``np.savez`` keys
of ``:323-371``: either package loads the other's) and interface contract,
plus a ``device`` parameter. Update and remove rebuild the trees, as in
the reference (``mrpt.py:428-442``); each query examines about
``num_trees * N / 2^depth`` points.

The database projects against the trees' bases on the device
(``ops/mrpt.project_all``); the trees are built on the host
(``build_trees``). A query batch runs one of two routes:

- the mirror route (``ops/mrpt.mrpt_query_mirror``): per-tree
  leaf-ordered SQ8 copies of the rows, each (query, tree) leaf a
  contiguous window scored by K6's int8 form, then the exact re-rank;
- the gather route (``ops/mrpt.mrpt_query``): the leaves' rows gathered
  from the f32 database and scored in chunks, then the exact re-rank.

The mirror is built at upload when ``SMQTK_TPU_NO_MRPT_MIRROR`` is unset,
the capacity holds at least one K6 window and the T copies fit
``MIRROR_BUDGET``; it serves queries with k (rounded up to a power of
two) <= 64. The JAX index also requires the arrays to sit on a TPU; the
port keeps the TPU routing on every device (``ops/device.
tpu_kernel_enabled``), so on the CPU the mirror route runs K6's plain
version where the JAX index builds no mirror.

With ``n_devices > 1`` the rows and the per-shard leaf tables are sharded
and every query takes the gather route a shard
(``parallel.sharded_mrpt``), as in JAX: no mirror is built.

Example, on the CPU::

    index = MRPTNearestNeighborsIndex(num_trees=8, depth=3, random_seed=0,
                                      device="cpu")
    index.build_index(elements)
    neighbours, dists = index.nn(elements[0], 10)
"""
from __future__ import annotations

import io
import logging
import threading
import warnings
from typing import Any, Dict, Hashable, Iterable, List, Optional, Sequence

import numpy as np
import torch

from smqtk_indexing_tpu_torch.core.configuration import (
    from_config_dict, make_default_config, merge_dict, to_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataElement
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorElement, DescriptorMemoryElement, DescriptorSet,
    MemoryDescriptorSet, stack_vectors,
)
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu_torch.models.nn_index._results import (
    assemble_results,
)
from smqtk_indexing_tpu_torch.ops import sq8 as sq8_ops
from smqtk_indexing_tpu_torch.ops.device import (
    capacity_for, device_report, pad_dim, pad_rows_np, pow2_at_least,
    tpu_kernel_enabled,
)
from smqtk_indexing_tpu_torch.ops.ivf_scan import L_MAX
from smqtk_indexing_tpu_torch.ops.mrpt import (
    build_trees, mrpt_query, mrpt_query_mirror, project_all,
)
from smqtk_indexing_tpu_torch.parallel.mesh import (
    device_config, mesh_for, primary_device, replicate, shard_rows,
)
from smqtk_indexing_tpu_torch.parallel.sharded_mrpt import (
    shard_leaf_tables, sharded_mrpt_query,
)
from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS, trace_span

LOG = logging.getLogger(__name__)


class MRPTNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Approximate kNN via multiple balanced random-projection trees.

    :param descriptor_set: Backing descriptor element storage.
    :param index_element: Optional DataElement persisting the built trees
        (the JAX package's payload: either package loads the other's).
    :param num_trees: Number of trees (reference guidance: about
        3k / leaf_size).
    :param depth: Tree depth; each query examines about
        num_trees * N / 2^depth points. Clamped (with a warning) so leaves
        are non-empty.
    :param random_seed: Seed of the Gaussian projection bases (numpy, as
        the JAX package draws them).
    :param read_only: Refuse mutations when True.
    :param n_devices: Row-shard the database and leaf tables across this
        many devices (a power of two); queries run the per-shard leaf scan
        (the gather route: the mirror is single-device) and the k-sized
        merge (``parallel/sharded_mrpt.py``). None or 1: one device.
    :param device: torch device holding the index: 'cuda' (default; raises
        when no card is present) or 'cpu' (the kernels' plain versions).
        With ``n_devices=n``: 'cuda' is cards 0 .. n-1 (too few raise),
        'cpu' n CPU shards, and a list of n device strings places each
        shard (a card may repeat).
    """

    #: Mirror residency budget (bytes): T leaf-ordered int8 copies.
    MIRROR_BUDGET = 8 << 30

    # is_usable() keeps the default True: this module imports torch, so
    # the class exists only where torch imports. HOW it runs (CUDA kernels
    # or their plain CPU versions) is in usability_report().

    @classmethod
    def usability_report(cls) -> dict:
        r = super().usability_report()
        # The JAX index's switches (mrpt.py:78-83): a set one is listed
        # and marks the index degraded.
        r.update(device_report("cuda", flags=(
            "SMQTK_TPU_NO_MRPT_MIRROR", "SMQTK_TPU_NO_NATIVE")))
        return r

    @classmethod
    def get_default_config(cls) -> Dict[str, Any]:
        c = super().get_default_config()
        c["descriptor_set"] = make_default_config(DescriptorSet.get_impls())
        c["index_element"] = make_default_config(DataElement.get_impls())
        return c

    @classmethod
    def from_config(cls, config_dict: Dict, merge_default: bool = True
                    ) -> "MRPTNearestNeighborsIndex":
        if merge_default:
            config_dict = merge_dict(cls.get_default_config(),
                                     dict(config_dict))
        cfg = dict(config_dict)
        for slot, iface in (("descriptor_set", DescriptorSet),
                            ("index_element", DataElement)):
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
        num_trees: int = 10,
        depth: int = 1,
        random_seed: Optional[int] = None,
        read_only: bool = False,
        n_devices: Optional[int] = None,
        device: str = "cuda",
    ):
        super().__init__()
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.index_element = index_element
        self.num_trees = int(num_trees)
        self.depth = int(depth)
        self.random_seed = random_seed
        self.read_only = bool(read_only)
        self.n_devices = n_devices
        self._device = primary_device(device)
        self.device = device_config(device)
        self._mesh_cfg = mesh_for(n_devices, device)

        self._model_lock = threading.RLock()
        self._reset_state()
        self._load_index()

    def _reset_state(self) -> None:
        self._dim: Optional[int] = None
        self._host: Optional[np.ndarray] = None
        self._row2uid: List[Hashable] = []
        self._uid2row: Dict[Hashable, int] = {}
        self._bases_np: Optional[np.ndarray] = None
        self._splits_np: Optional[np.ndarray] = None
        self._leaf_np: Optional[np.ndarray] = None
        self._offsets_np: Optional[np.ndarray] = None
        self._depth_eff = 0
        self._leaf_max = 0
        self._capacity = 0
        # device
        self._dev: Optional[torch.Tensor] = None
        self._dev_sq = None
        self._dev_valid = None
        self._dev_bases = None
        self._dev_splits = None
        self._dev_leaf = None
        self._dev_offsets = None
        # leaf-ordered SQ8 mirror (ops/mrpt.mrpt_query_mirror)
        self._mirror: Optional[torch.Tensor] = None
        self._mir_a = None
        self._mir_b = None
        self._leaf_flat = None
        # sharded state (n_devices > 1)
        self._mesh = None
        self._leaf_max_sh = 0
        self._dev_leaf_local = None
        self._dev_off_local = None

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        c.update({
            "num_trees": self.num_trees,
            "depth": self.depth,
            "random_seed": self.random_seed,
            "read_only": self.read_only,
            "n_devices": self.n_devices,
            "device": self.device,
        })
        return c

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    # ------------------------------------------------------------------
    # build
    # ------------------------------------------------------------------
    def _rebuild(self, mat: np.ndarray, uids: Sequence[Hashable]) -> None:
        n, d = mat.shape
        self._dim = d
        depth_eff = self.depth
        max_depth = max(int(np.floor(np.log2(max(n, 2)))), 1)
        if depth_eff > max_depth:
            warnings.warn(
                f"Requested depth {depth_eff} too deep for {n} rows; "
                f"clamping to {max_depth} (examined points ≈ "
                f"num_trees * N / 2^depth).")
            depth_eff = max_depth
        self._depth_eff = depth_eff

        rng = np.random.default_rng(self.random_seed)
        d_pad = pad_dim(d)
        bases = rng.standard_normal(
            (self.num_trees, d, depth_eff)).astype(np.float32)
        bases_p = np.zeros((self.num_trees, d_pad, depth_eff),
                           dtype=np.float32)
        bases_p[:, :d, :] = bases

        dev = self._to_dev(pad_rows_np(mat, capacity_for(n), d_pad))
        projs = project_all(dev, self._to_dev(bases_p))[:n].cpu().numpy()
        splits, leaf_table, offsets = build_trees(projs, depth_eff)
        LOG.debug("Built %d trees depth %d over %d rows (leaf sizes %d-%d)",
                  self.num_trees, depth_eff, n,
                  int(np.diff(offsets).min()), int(np.diff(offsets).max()))

        self._host = mat
        self._row2uid = list(uids)
        self._uid2row = {u: i for i, u in enumerate(uids)}
        self._bases_np = bases_p
        self._splits_np = splits
        self._leaf_np = leaf_table
        self._offsets_np = offsets
        self._leaf_max = pow2_at_least(int(np.diff(offsets).max()))
        self._upload(dev, n)
        self._save_index()

    def _upload(self, dev: torch.Tensor, n: int) -> None:
        """Device state of the trees over ``dev``, the (capacity, d_pad)
        padded rows already on the device."""
        # A mirror laid out for the old trees must never be scanned against
        # new leaf offsets: drop it before the gate decides.
        self._mirror = self._mir_a = self._mir_b = self._leaf_flat = None
        self._capacity = dev.shape[0]
        sq = np.zeros(self._capacity, dtype=np.float32)
        sq[:n] = np.einsum("ij,ij->i", self._host, self._host)
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:n] = True
        # leaf_table indexes real rows only; pad with clamped zeros.
        mesh = self._mesh_cfg
        if mesh is not None:
            self._upload_sharded(mesh, dev, sq, valid)
            return
        self._mesh = None
        leaf_pad = np.zeros((self.num_trees, self._capacity), dtype=np.int32)
        leaf_pad[:, :n] = self._leaf_np
        self._dev = dev
        self._dev_sq = self._to_dev(sq)
        self._dev_valid = self._to_dev(valid)
        self._dev_bases = self._to_dev(self._bases_np)
        self._dev_splits = self._to_dev(self._splits_np)
        self._dev_leaf = self._to_dev(leaf_pad)
        self._dev_offsets = self._to_dev(self._offsets_np)
        self._maybe_build_mirror(leaf_pad, n)

    def _upload_sharded(self, mesh, dev: torch.Tensor, sq: np.ndarray,
                        valid: np.ndarray) -> None:
        """The mesh branch of ``_upload`` (``mrpt.py:251-271``): rows,
        norms and liveness row-sharded, the leaf permutation laid out per
        shard (``shard_leaf_tables``), bases and splits replicated; no
        mirror."""
        leaf_loc, off_loc, lmax = shard_leaf_tables(
            self._leaf_np, self._offsets_np, mesh.size, self._capacity)
        self._leaf_max_sh = pow2_at_least(max(lmax, 1))
        self._dev = shard_rows(mesh, dev)
        self._dev_sq = shard_rows(mesh, sq)
        self._dev_valid = shard_rows(mesh, valid)
        self._dev_bases = replicate(mesh, self._bases_np)
        self._dev_splits = replicate(mesh, self._splits_np)
        self._dev_leaf_local = shard_rows(mesh, leaf_loc)
        self._dev_off_local = shard_rows(mesh, off_loc)
        self._mesh = mesh

    def mirror_bytes(self) -> int:
        """Bytes the T leaf-ordered copies take: T * capacity * d_pad."""
        return self.num_trees * self._capacity * self._bases_np.shape[1]

    def _maybe_build_mirror(self, leaf_pad: np.ndarray, n: int) -> None:
        """Per-tree leaf-ordered SQ8 mirrors (``mrpt.py:288-318``): each
        (query, tree) candidate fetch becomes one contiguous K6 window
        instead of a scattered f32 row gather, for T bytes a dim of extra
        residency. ``SMQTK_TPU_NO_MRPT_MIRROR=1`` disables it."""
        if not (tpu_kernel_enabled("SMQTK_TPU_NO_MRPT_MIRROR")
                and self._capacity >= L_MAX
                and self.mirror_bytes() <= self.MIRROR_BUDGET):
            return
        d_pad = self._bases_np.shape[1]
        self._mir_a, self._mir_b, codes_dev, _, _ = \
            sq8_ops.sq8_build_store(
                self._host, np.ones(n, dtype=bool), self._capacity,
                d_pad, self._dim, self._device)
        self._leaf_flat = self._dev_leaf.reshape(-1)
        self._mirror = codes_dev[self._leaf_flat.long()]

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def _save_index(self) -> None:
        if self.index_element is None:
            return
        if self.index_element.is_read_only():
            raise ReadOnlyError(
                f"Index element {self.index_element} is read-only.")
        bio = io.BytesIO()
        np.savez(bio, matrix=self._host,
                 uids=np.array(self._row2uid, dtype=object),
                 bases=self._bases_np, splits=self._splits_np,
                 leaf_table=self._leaf_np, offsets=self._offsets_np,
                 depth_eff=np.array(self._depth_eff))
        self.index_element.set_bytes(bio.getvalue())

    def _load_index(self) -> None:
        if self.index_element is None or self.index_element.is_empty():
            return
        with np.load(io.BytesIO(self.index_element.get_bytes()),
                     allow_pickle=True) as z:
            mat = z["matrix"]
            uids = list(z["uids"])
            self._bases_np = z["bases"]
            self._splits_np = z["splits"]
            self._leaf_np = z["leaf_table"]
            self._offsets_np = z["offsets"]
            self._depth_eff = int(z["depth_eff"])
        n, d = mat.shape
        self._dim = d
        self._host = mat
        self._row2uid = uids
        self._uid2row = {u: i for i, u in enumerate(uids)}
        self._leaf_max = pow2_at_least(int(np.diff(self._offsets_np).max()))
        d_pad = self._bases_np.shape[1]
        self._upload(self._to_dev(pad_rows_np(mat, capacity_for(n), d_pad)),
                     n)
        if self.descriptor_set.count() != n:
            LOG.warning(
                "Descriptor set size (%d) disagrees with loaded index size "
                "(%d); repopulating from index payload.",
                self.descriptor_set.count(), n)
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(
                DescriptorMemoryElement(u, mat[i])
                for i, u in enumerate(uids))

    # ------------------------------------------------------------------
    # index API
    # ------------------------------------------------------------------
    def count(self) -> int:
        return len(self._uid2row)

    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            by_uid = {e.uuid(): e for e in descriptors}
            uids = list(by_uid.keys())
            mat = stack_vectors([by_uid[u] for u in uids])
            self._rebuild(mat, uids)
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(by_uid.values())

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        # Reference semantics: update is a full rebuild over old + new
        # (mrpt.py:428-436).
        with self._model_lock:
            self._guard_read_only()
            by_uid = {e.uuid(): e for e in descriptors}
            if self._host is not None:
                fresh = [u for u in by_uid if u not in self._uid2row]
                # Always copy, never alias self._host: re-sent UIDs are
                # replaced in the copy, so the live index is untouched
                # until _rebuild completes.
                mat = np.vstack(
                    [self._host]
                    + [np.asarray(by_uid[u].vector(), dtype=np.float32)
                       .reshape(1, -1) for u in fresh]) \
                    if fresh else self._host.copy()
                for u in by_uid:
                    if u in self._uid2row:
                        mat[self._uid2row[u]] = by_uid[u].vector()
                uids = list(self._row2uid) + fresh
            else:
                uids = list(by_uid.keys())
                mat = stack_vectors([by_uid[u] for u in uids])
            self._rebuild(np.ascontiguousarray(mat, dtype=np.float32), uids)
            self.descriptor_set.add_many_descriptors(by_uid.values())

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        # Reference semantics: remove is a full rebuild over the remainder
        # (mrpt.py:437-442), KeyError with no mutation on unknown UIDs.
        with self._model_lock:
            self._guard_read_only()
            uids = list(uids)
            for u in uids:
                if u not in self._uid2row:
                    raise KeyError(u)
            dead = {self._uid2row[u] for u in uids}
            keep = [i for i in range(len(self._row2uid)) if i not in dead]
            self.descriptor_set.remove_many_descriptors(uids)
            if not keep:
                self._reset_state()
                if self.index_element is not None \
                        and not self.index_element.is_read_only():
                    self.index_element.set_bytes(b"")
                return
            self._rebuild(np.ascontiguousarray(self._host[keep]),
                          [self._row2uid[i] for i in keep])

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        return self._nn_many([d], n)[0]

    def _nn_many(self, ds: Sequence[DescriptorElement],
                 n: int = 1) -> List[NNResult]:
        q = np.vstack([d.vector() for d in ds]).astype(np.float32)
        with self._model_lock:
            if self._host is None:
                raise ValueError("No index currently set to query from!")
            if q.shape[1] != self._dim:
                raise ValueError(
                    f"Query dim {q.shape[1]} != index dim {self._dim}")
            b = q.shape[0]
            q_p = pad_rows_np(q, pow2_at_least(b, 8),
                              self._bases_np.shape[1])
            k_eff = min(n, self.count())
            k_dev = min(pow2_at_least(k_eff), self._capacity)
            COUNTERS.add("mrpt.queries", b)
            COUNTERS.add("mrpt.candidates_examined",
                         b * self.num_trees * self._leaf_max)
            with trace_span("mrpt.query"):
                qd = self._to_dev(q_p)
                if self._mesh is not None:
                    dists, rows = sharded_mrpt_query(
                        self._mesh, self._dev, self._dev_sq,
                        self._dev_valid, self._dev_bases, self._dev_splits,
                        self._dev_leaf_local, self._dev_off_local, qd,
                        k=k_dev, depth=self._depth_eff,
                        leaf_max=self._leaf_max_sh)
                elif self._mirror is not None and k_dev <= 64:
                    # The mirror's selection margin scales with
                    # k * num_trees, so large k takes the gather route.
                    dists, rows = mrpt_query_mirror(
                        self._dev, self._dev_sq, self._dev_bases,
                        self._dev_splits, self._mirror, self._mir_a,
                        self._mir_b, self._leaf_flat, self._dev_offsets,
                        qd, k=k_dev, depth=self._depth_eff,
                        leaf_max=self._leaf_max)
                else:
                    dists, rows = mrpt_query(
                        self._dev, self._dev_sq, self._dev_valid,
                        self._dev_bases, self._dev_splits, self._dev_leaf,
                        self._dev_offsets, qd, k=k_dev,
                        depth=self._depth_eff, leaf_max=self._leaf_max)
                dists = dists[:b, :k_eff].cpu().numpy()
                rows = rows[:b, :k_eff].cpu().numpy()
            with trace_span("mrpt.assemble"):
                out = assemble_results(dists, rows, self._row2uid,
                                       self.descriptor_set)
        shortest = min(len(r[0]) for r in out)
        if shortest < n:
            # Reference under-fill warning (mrpt.py:503-508).
            if n > self.count():
                warnings.warn(
                    f"Requested {n} neighbors but only {self.count()} "
                    "are indexed.")
            else:
                warnings.warn(
                    f"Requested {n} neighbors but some queries reached "
                    f"only {shortest} candidates; increase num_trees or "
                    "decrease depth for more coverage.")
        return out
