"""
IVF (inverted-file, coarse-quantized) nearest-neighbour index on a CUDA
device.

Port of ``smqtk_indexing_tpu/models/nn_index/ivf.py:52-813``: the same
constructor, JSON configuration, persisted payload and interface
contract, plus a ``device`` parameter. k-means trains the coarse
centroids (``ops/kmeans.py``); the rows are laid out sorted by list, so
each inverted list is a contiguous range; a query batch ranks the
centroids, scans the rows of the ``nprobe`` nearest lists (FAISS's
nprobe, in original lists) and returns the k best. Three engines, each on
its hand-written kernel (the routing is the JAX package's TPU routing, on
every device):

- code tier (``storage='code'``): the tiled scan (``_ivf_code``), K7 over
  SQ8 codes (``ops/ivf_scan.ivf_query_dma_tiled_table``) or K8 over PQ
  codes (``ivf_query_dma_tiled_table_pq``); with ``rerank='exact'`` the
  winners' segments come through K3;
- rows tier, euclidean f32 / bf16 / sq8: the row-major scan, K6
  (``_ivf_rows``, ``ops/ivf_scan.ivf_query_dma``); rows-tier sq8 with
  ``rerank='score'`` and rows-tier euclidean PQ take the tiled engine;
- the rest (rows-tier inner_product and cosine, and lists longer than
  K6's window): the plain list gathers of ``ops/ivf.ivf_query`` and
  ``ivf_query_pq``.

The JAX index's switches take the rows tier off its kernels, under their
names (``_tiled_rows_ok``, ``_dma_eligible``): ``SMQTK_TPU_NO_ROWS_TILED``
(row-major layout), ``SMQTK_TPU_ROWS_TILED`` (the tiled routing for sq8
whatever its finalization) and ``SMQTK_TPU_NO_DMA_IVF`` (neither the tiled
routing nor K6). The code tier keeps its tiled engine, as in JAX.

PQ ('pq<M>') and OPQ ('opq<M>') codes live on the codec grid: the padded
dims extended to a multiple of M, interleaved round-robin over the
subspaces, and for OPQ rotated. ``pq_residual=True`` encodes
``x - centroid(list)`` (FAISS ``by_residual``).

Select it in configuration by its fully-qualified key,
``"smqtk_indexing_tpu_torch.models.nn_index.ivf.IvfNearestNeighborsIndex"``:
the bare class name is shared with the JAX package's index.

Example, on the CPU::

    index = IvfNearestNeighborsIndex(n_lists=16, nprobe=4, random_seed=0,
                                     device="cpu")
    index.build_index(elements)
    neighbours, dists = index.nn(elements[0], 10)
"""
from __future__ import annotations

import logging
import os
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
    DescriptorElement, DescriptorSet, MemoryDescriptorSet, stack_vectors,
)
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.data.key_value import KeyValueStore
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex, NNResult,
)
from smqtk_indexing_tpu_torch.models.nn_index import (
    _ivf_code, _ivf_persist, _ivf_rows,
)
from smqtk_indexing_tpu_torch.models.nn_index._ivf_matrix import (
    validate_ivf_combination,
)
from smqtk_indexing_tpu_torch.models.nn_index._kvs import sync_uid_kvs
from smqtk_indexing_tpu_torch.models.nn_index._results import (
    assemble_results,
)
from smqtk_indexing_tpu_torch.ops.device import (
    device_report, pad_dim, pad_rows_np, pow2_at_least,
    tpu_kernel_enabled,
)
from smqtk_indexing_tpu_torch.ops.ivf_scan import L_MAX
from smqtk_indexing_tpu_torch.ops.kmeans import kmeans_assign, kmeans_lloyd
from smqtk_indexing_tpu_torch.ops.pq import (
    pq_codec_dim, pq_decode_np, pq_m, pq_perm,
    pq_prep_queries, pq_rotate,
)
from smqtk_indexing_tpu_torch.parallel.mesh import (
    device_config, mesh_for, primary_device, shard_rows,
)
from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS, trace_span

LOG = logging.getLogger(__name__)


class IvfNearestNeighborsIndex (NearestNeighborsIndex):
    """
    Coarse-quantized approximate kNN: k-means cells and per-query list
    probing.

    :param descriptor_set: Backing descriptor element storage.
    :param index_element: Optional DataElement persisting the trained index
        (the JAX package's payload: either package loads the other's).
    :param metric: 'euclidean' | 'inner_product' | 'cosine'.
    :param n_lists: Number of coarse cells; 0 = about sqrt(N), a power of
        two in [16, 4096].
    :param nprobe: Cells probed per query (query-time tunable).
    :param kmeans_iterations: Lloyd iterations for training.
    :param max_points_per_centroid: Training subsample cap (n_lists times
        this), as FAISS's clustering parameter of the same name.
    :param random_seed: Seed of the k-means init and training subsample
        (numpy, as the JAX package draws them, so one seed gives one init
        in both packages).
    :param dtype: Device storage: 'float32' | 'bfloat16' | 'sq8' |
        'pq<M>' (product quantization, M bytes a vector) | 'opq<M>' (PQ
        behind a learned OPQ rotation).
    :param storage: 'rows' (float32 host mirror) or 'code' (the capacity
        tier: the host mirror and the payload are the codes, int8 SQ8 or
        uint8 PQ; requires dtype='sq8', 'pq<M>' or 'opq<M>').
    :param rerank: Finalization on the tiled engine: 'exact' re-ranks the
        winners from their decoded codes; 'score' reports the kernel's
        surrogate distance and skips the gather.
    :param read_only: Refuse mutations when True.
    :param n_devices: Row-shard the list-sorted database across this many
        devices (a power of two): the code tier shards its tiles (K7 / K8
        a shard, ``parallel/sharded_ivf_code.py``), the rows tier its rows
        (the list gathers a shard, ``parallel/sharded_ivf.py``); lists cut
        by a shard boundary are probed by both owners, and the per-shard
        winners merge. None or 1: one device.
    :param pq_residual: PQ dtypes only: encode residuals to the list
        centroid (euclidean; cosine on the code tier).
    :param device: torch device holding the index: 'cuda' (default; raises
        when no card is present) or 'cpu' (the kernels' plain versions).
        With ``n_devices=n``: 'cuda' is cards 0 .. n-1 (too few raise),
        'cpu' n CPU shards, and a list of n device strings places each
        shard (a card may repeat).
    """

    # is_usable() keeps the default True: this module imports torch, so
    # the class exists only where torch imports. HOW it runs (CUDA kernels
    # or their plain CPU versions) is in usability_report().

    @classmethod
    def usability_report(cls) -> dict:
        r = super().usability_report()
        # The JAX index's switches (ivf.py:136-141): a set one is listed
        # and marks the index degraded.
        r.update(device_report("cuda", flags=(
            "SMQTK_TPU_NO_DMA_IVF", "SMQTK_TPU_NO_ROWS_TILED")))
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
                    ) -> "IvfNearestNeighborsIndex":
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
        n_lists: int = 0,
        nprobe: int = 8,
        kmeans_iterations: int = 10,
        max_points_per_centroid: int = 256,
        random_seed: Optional[int] = None,
        dtype: str = "float32",
        storage: str = "rows",
        rerank: str = "exact",
        read_only: bool = False,
        n_devices: Optional[int] = None,
        pq_residual: bool = False,
        uid2idx_kvs=None,
        idx2uid_kvs=None,
        device: str = "cuda",
    ):
        super().__init__()
        validate_ivf_combination(metric, dtype, storage, rerank, n_devices,
                                 pq_residual)
        self.descriptor_set = descriptor_set if descriptor_set is not None \
            else MemoryDescriptorSet()
        self.index_element = index_element
        self.metric = metric
        self.n_lists = int(n_lists)
        self.nprobe = int(nprobe)
        self.kmeans_iterations = int(kmeans_iterations)
        self.max_points_per_centroid = int(max_points_per_centroid)
        self.random_seed = random_seed
        self.dtype = dtype
        self.storage = storage
        self.rerank = rerank
        self.read_only = bool(read_only)
        self.n_devices = n_devices
        self.pq_residual = bool(pq_residual)
        self._device = primary_device(device)
        self.device = device_config(device)
        self._mesh_cfg = mesh_for(n_devices, device)
        # Optional external uid<->idx mirrors (see _kvs.py).
        self.uid2idx_kvs = uid2idx_kvs
        self.idx2uid_kvs = idx2uid_kvs

        self._model_lock = threading.RLock()
        self._reset_state()
        self._load_index()

    _pq_m = staticmethod(pq_m)
    _pq_rotate = staticmethod(pq_rotate)

    def _pq_grid(self):
        """(m, d_codec, perm) of the PQ codec grid, which follows from the
        padded dim, so only the learned codebooks and rotation persist."""
        m = self._pq_m(self.dtype)
        d_codec = pq_codec_dim(self._centroids_np.shape[1], m)
        return m, d_codec, pq_perm(d_codec, m)

    def _pq_cents_codec(self, rot: Optional[np.ndarray]) -> np.ndarray:
        """(C, d_codec) float32 centroids in the codec space (interleave,
        and the OPQ rotation ``rot``): the residual codec's frame. The
        ``rot=None`` form is cached until the next full build."""
        if rot is None and self._cents_codec_cache is not None:
            return self._cents_codec_cache
        c = pq_prep_queries(self._centroids_np.astype(np.float32),
                            self._pq_grid()[2], rot)
        if rot is None:
            self._cents_codec_cache = c
        return np.ascontiguousarray(c)

    def _pq_prep_rows(self, mat: np.ndarray,
                      rotate: bool = True) -> np.ndarray:
        """Float rows -> (n, d_codec) codec-grid rows: interleaved, and
        with ``rotate`` and a trained code-tier rotation, rotated."""
        return pq_prep_queries(np.asarray(mat, np.float32),
                               self._pq_grid()[2],
                               self._code_rot if rotate else None)

    def _dma_eligible(self) -> bool:
        """Rows tier through K6 (``ivf.py:289-302``): ``SMQTK_TPU_NO_DMA_IVF``
        unset (read per query), euclidean, every sublist inside the
        kernel's window less its alignment slack, and a capacity of at
        least one window."""
        return (tpu_kernel_enabled("SMQTK_TPU_NO_DMA_IVF")
                and self._mesh is None
                and self.metric == "euclidean"
                and 0 < self._l_max_raw <= L_MAX - 32
                and self._capacity >= L_MAX)

    def _tiled_rows_ok(self) -> bool:
        """The rows tier's routed cells take the tiled engine
        (``ivf.py:304-337``, the TPU routing, read at each layout): only
        single-device euclidean PQ / OPQ and sq8 qualify, then in the JAX
        order

        1. ``SMQTK_TPU_NO_ROWS_TILED`` set: row-major;
        2. ``SMQTK_TPU_ROWS_TILED`` set: tiled;
        3. sq8 without score finalization (score mode exists only on the
           tiled engine): row-major;
        4. otherwise tiled (K7 / K8) unless ``SMQTK_TPU_NO_DMA_IVF`` is
           set.
        """
        if self.storage != "rows" \
                or (self.dtype != "sq8" and self._pq_m(self.dtype) is None) \
                or self.metric != "euclidean" \
                or self._mesh_cfg is not None \
                or os.environ.get("SMQTK_TPU_NO_ROWS_TILED"):
            return False
        if os.environ.get("SMQTK_TPU_ROWS_TILED"):
            return True
        if self.dtype == "sq8" and self.rerank != "score":
            return False
        return tpu_kernel_enabled("SMQTK_TPU_NO_DMA_IVF")

    def _make_mesh(self):
        """The device mesh of ``n_devices`` / ``device``, or None."""
        return self._mesh_cfg

    def _reset_state(self) -> None:
        # Device mesh of the uploaded state (None: one device).
        self._mesh = None
        # Host source of truth, in list-sorted order.
        self._dim: Optional[int] = None
        self._host: Optional[np.ndarray] = None        # f32 rows / codes
        self._valid_host: Optional[np.ndarray] = None
        self._row2uid: List[Hashable] = []
        self._uid2row: Dict[Hashable, int] = {}
        self._assign_host: Optional[np.ndarray] = None
        self._n_live = 0
        self._centroids_np: Optional[np.ndarray] = None  # (C, d_pad) f32
        # Row-major device state (_ivf_rows).
        self._dev = self._dev_sq = self._dev_norm = self._dev_valid = None
        self._dev_centroids = self._dev_offsets = self._dev_lens = None
        self._dev_first_virt = None
        self._capacity = 0
        self._l_max = 0
        self._l_max_raw = 0
        self._n_virtual = 0
        self._max_split = 1
        # SQ8 device codec (either layout).
        self._sq8_a = self._sq8_b = None
        # Code tier host codec: trained once, reused by updates (SQ8 scale
        # and offset, or PQ codebooks and OPQ rotation).
        self._code_a: Optional[np.ndarray] = None
        self._code_b: Optional[np.ndarray] = None
        self._code_cb: Optional[np.ndarray] = None
        self._code_rot: Optional[np.ndarray] = None
        self._cents_codec_cache: Optional[np.ndarray] = None
        # Tiled device state (_ivf_code); +inf stats poison dead rows.
        self._dev3 = self._s2t = None
        self._v_tile = self._v_col = self._v_len = self._slot_table = None
        # PQ device codec (either layout): codebooks and the query
        # transform (interleave, or the interleave-and-rotation matrix);
        # residual PQ's codec-space centroids and row -> list map.
        self._cb_dev = self._pq_cb_dev = self._perm_dev = None
        self._cents_codec_dev = self._row2list_dev = None

    def get_config(self) -> Dict[str, Any]:
        c = self.get_default_config()
        c["descriptor_set"] = merge_dict(
            c["descriptor_set"], to_config_dict(self.descriptor_set))
        if self.index_element is not None:
            c["index_element"] = merge_dict(
                c["index_element"], to_config_dict(self.index_element))
        c.update({
            "metric": self.metric,
            "n_lists": self.n_lists,
            "nprobe": self.nprobe,
            "kmeans_iterations": self.kmeans_iterations,
            "max_points_per_centroid": self.max_points_per_centroid,
            "random_seed": self.random_seed,
            "dtype": self.dtype,
            "storage": self.storage,
            "rerank": self.rerank,
            "read_only": self.read_only,
            "n_devices": self.n_devices,
            "pq_residual": self.pq_residual,
            "device": self.device,
        })
        if self.uid2idx_kvs is not None:
            c["uid2idx_kvs"] = merge_dict(
                c["uid2idx_kvs"], to_config_dict(self.uid2idx_kvs))
        if self.idx2uid_kvs is not None:
            c["idx2uid_kvs"] = merge_dict(
                c["idx2uid_kvs"], to_config_dict(self.idx2uid_kvs))
        return c

    # ------------------------------------------------------------------
    # training + layout
    # ------------------------------------------------------------------
    def _auto_lists(self, n: int) -> int:
        if self.n_lists > 0:
            return self.n_lists
        return min(max(pow2_at_least(int(np.sqrt(n))), 16), 4096)

    def _prep_for_metric(self, mat: np.ndarray) -> np.ndarray:
        """Cosine cells train and assign on unit rows, so the L2 coarse
        quantizer matches angular neighbourhoods."""
        if self.metric == "cosine":
            norms = np.linalg.norm(mat, axis=1, keepdims=True)
            return mat / np.where(norms == 0, 1.0, norms)
        return mat

    def _to_dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self._device)

    def _train_centroids(self, mat: np.ndarray) -> np.ndarray:
        n = mat.shape[0]
        c_count = min(self._auto_lists(n), n)
        # The JAX package's draws (ivf.py:453-460), so one seed gives one
        # init in both packages.
        rng = np.random.default_rng(self.random_seed)
        train = self._prep_for_metric(mat)
        cap = c_count * self.max_points_per_centroid
        if n > cap:
            train = train[rng.choice(n, size=cap, replace=False)]
        init = train[rng.choice(train.shape[0], size=c_count,
                                replace=False)]
        d_pad = pad_dim(mat.shape[1])
        x = self._to_dev(pad_rows_np(train, train.shape[0], d_pad))
        valid = torch.ones(train.shape[0], dtype=torch.bool,
                           device=self._device)
        centroids, _ = kmeans_lloyd(
            x, valid, self._to_dev(pad_rows_np(init, c_count, d_pad)),
            n_iter=self.kmeans_iterations)
        LOG.debug("Trained %d IVF centroids on %d rows", c_count,
                  train.shape[0])
        return centroids.cpu().numpy()

    def _assign(self, mat: np.ndarray) -> np.ndarray:
        d_pad = self._centroids_np.shape[1]
        x = self._to_dev(pad_rows_np(self._prep_for_metric(mat),
                                     mat.shape[0], d_pad))
        a = kmeans_assign(x, self._to_dev(self._centroids_np))
        return a.cpu().numpy().astype(np.int32)

    def _layout(self, mat: np.ndarray, uids: Sequence[Hashable],
                assigns: np.ndarray,
                valid: Optional[np.ndarray] = None) -> None:
        """Sort rows by list id and upload. On the code tier ``mat`` is
        float32 rows on a first build (the codec trains here, once) or
        int8 codes on a re-layout; the host mirror is always the codes."""
        order = np.argsort(assigns, kind="stable")
        mat = mat[order]
        assigns = assigns[order]
        uids = [uids[i] for i in order]
        valid = np.ones(mat.shape[0], dtype=bool) if valid is None \
            else valid[order]
        if self.storage == "code":
            self._host = np.ascontiguousarray(
                _ivf_code.encode_rows(self, mat, assigns, valid))
        else:
            self._host = np.ascontiguousarray(mat, dtype=np.float32)
        self._valid_host = valid
        self._row2uid = list(uids)
        self._uid2row = {u: i for i, u in enumerate(uids) if valid[i]}
        self._assign_host = assigns
        self._n_live = int(valid.sum())
        if self.storage == "code":
            _ivf_code.upload_tiled(self)
        else:
            _ivf_rows.upload_rows(self)

    def _save_index(self) -> None:
        _ivf_persist.save_index(self)

    def _load_index(self) -> None:
        _ivf_persist.load_index(self)

    def _row_vector(self, i: int) -> np.ndarray:
        """Float view of host row ``i``: the code tier decodes its codes,
        the only float those rows have (PQ: rotated back out of the OPQ
        frame, the list centroid added back for residuals, the interleave
        undone)."""
        if self.storage != "code":
            return self._host[i]
        if self._pq_m(self.dtype) is None:
            return (self._host[i].astype(np.float32) * self._code_a
                    + self._code_b)
        x_c = pq_decode_np(self._host[i:i + 1], self._code_cb)
        if self._code_rot is not None:
            x_c = x_c @ self._code_rot.T
        if self.pq_residual:
            x_c = x_c + self._pq_cents_codec(None)[
                self._assign_host[i:i + 1]]
        return x_c[0, np.argsort(self._pq_grid()[2])][:self._dim]

    # ------------------------------------------------------------------
    # index API
    # ------------------------------------------------------------------
    def count(self) -> int:
        return self._n_live

    def _guard_read_only(self) -> None:
        if self.read_only:
            raise ReadOnlyError("Cannot modify read-only index.")

    def _sync_kvs(self) -> None:
        self._kvs_synced = sync_uid_kvs(
            self.uid2idx_kvs, self.idx2uid_kvs, dict(self._uid2row),
            prev=getattr(self, "_kvs_synced", None))

    def _build_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            by_uid = {e.uuid(): e for e in descriptors}
            uids = list(by_uid.keys())
            mat = stack_vectors([by_uid[u] for u in uids])
            self._dim = int(mat.shape[1])
            # A full build retrains the codec too (FAISS train()).
            self._code_a = self._code_b = None
            self._code_cb = self._code_rot = self._cents_codec_cache = None
            with trace_span("ivf.train"):
                self._centroids_np = self._train_centroids(mat)
            self._layout(mat, uids, self._assign(mat))
            self.descriptor_set.clear()
            self.descriptor_set.add_many_descriptors(by_uid.values())
            self._sync_kvs()
            self._save_index()

    def _update_index(self, descriptors: Iterable[DescriptorElement]) -> None:
        with self._model_lock:
            self._guard_read_only()
            elems = list(descriptors)
            if self._host is None:
                self._build_index(elems)
                return
            by_uid = {e.uuid(): e for e in elems}
            fresh = [u for u in by_uid if u not in self._uid2row]
            skipped = len(by_uid) - len(fresh)
            if skipped:
                warnings.warn(
                    f"Skipped {skipped} already-indexed descriptor UID(s) "
                    "during update.")
            if fresh:
                new_mat = stack_vectors([by_uid[u] for u in fresh])
                new_assigns = self._assign(new_mat)
                keep = np.flatnonzero(self._valid_host)
                if self.storage == "code":
                    # Updates encode with the build-time codec (a FAISS
                    # quantizer never retrains on add), so the mirror stays
                    # codes; cosine codes carry unit rows.
                    new_mat = _ivf_code.encode_rows(
                        self, new_mat, new_assigns,
                        np.ones(len(fresh), dtype=bool))
                self._layout(
                    np.concatenate([self._host[keep], new_mat]),
                    [self._row2uid[i] for i in keep] + fresh,
                    np.concatenate([self._assign_host[keep], new_assigns]))
                self.descriptor_set.add_many_descriptors(
                    by_uid[u] for u in fresh)
            self._sync_kvs()
            self._save_index()

    def _remove_from_index(self, uids: Iterable[Hashable]) -> None:
        with self._model_lock:
            self._guard_read_only()
            uids = list(dict.fromkeys(uids))
            rows = []
            for u in uids:
                if u not in self._uid2row:
                    raise KeyError(u)
                rows.append(self._uid2row[u])
            for u in uids:
                del self._uid2row[u]
            self._valid_host[rows] = False
            self._n_live -= len(rows)
            if self._n_live == 0:
                kept = (self._centroids_np, self._dim, self._code_a,
                        self._code_b, self._code_cb, self._code_rot)
                self._reset_state()
                (self._centroids_np, self._dim, self._code_a,
                 self._code_b, self._code_cb, self._code_rot) = kept
            elif self._n_live < self._host.shape[0] // 2 \
                    and self._host.shape[0] > 1024:
                keep = np.flatnonzero(self._valid_host)
                self._layout(self._host[keep],
                             [self._row2uid[i] for i in keep],
                             self._assign_host[keep])
            elif self._dev3 is not None:
                _ivf_code.poison_rows(self, rows)
            elif self._mesh is not None:
                # The validity mask is sharded anew (ivf.py:703-710).
                valid = np.zeros(self._capacity, dtype=bool)
                valid[:len(self._valid_host)] = self._valid_host
                self._dev_valid = shard_rows(self._mesh, valid)
            else:
                self._dev_valid[torch.as_tensor(
                    rows, dtype=torch.long, device=self._device)] = False
            self.descriptor_set.remove_many_descriptors(uids)
            self._sync_kvs()
            self._save_index()

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def _nn(self, d: DescriptorElement, n: int = 1) -> NNResult:
        return self._nn_many([d], n)[0]

    def _probe_plan(self):
        """
        FAISS-faithful nprobe for the row-major engines (``ivf.py:742-769``):
        a virtual-slot budget for the worst case (each original list may
        split into ``_max_split`` sublists; +1 tied list, +8) and the
        original-list count to threshold at. ``nprobe >= n_lists`` probes
        every sublist: exhaustive and exact.

        :return: (slot budget, nprobe_orig or None, first_virt or None).
        """
        if self.nprobe >= self._centroids_np.shape[0]:
            return self._n_virtual, None, None
        budget = pow2_at_least((self.nprobe + 1) * self._max_split + 8)
        return (min(budget, self._n_virtual), self.nprobe,
                self._dev_first_virt)

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
            q_p = pad_rows_np(q, b, self._centroids_np.shape[1])
            if self.storage == "code" and self.metric == "cosine":
                # Code-tier cosine codes carry unit rows; so must queries.
                nrm = np.linalg.norm(q_p, axis=1, keepdims=True)
                q_p = q_p / np.where(nrm == 0, 1.0, nrm)
            k_eff = min(n, self._n_live)
            # k rounds up to a power of two as in the JAX package, whose
            # exact re-rank then sees the same k + 8 candidates.
            k_dev = min(pow2_at_least(k_eff), self._capacity)
            n_lists = self._centroids_np.shape[0]
            nprobe, nprobe_orig, first_virt = self._probe_plan()
            n_orig = min(self.nprobe, n_lists)
            COUNTERS.add("ivf.queries", b)
            COUNTERS.add("ivf.probed_lists", b * n_orig)
            COUNTERS.add("ivf.candidates_scanned_est",
                         b * n_orig * max(self._n_live // n_lists, 1))
            has_dead = not bool(self._valid_host.all())
            with trace_span("ivf.query"):
                qd = self._to_dev(q_p.astype(np.float32))
                res = _ivf_code.query_tiled(self, qd, k_dev)
                if res is None:
                    res = _ivf_rows.query_rows(
                        self, qd, k_dev, nprobe, first_virt, nprobe_orig,
                        has_dead)
                dists = res[0][:, :k_eff].cpu().numpy()
                rows = res[1][:, :k_eff].cpu().numpy()
            with trace_span("ivf.assemble"):
                # Unfilled slots carry row -1; the assembler trims them.
                out = assemble_results(dists, rows, self._row2uid,
                                       self.descriptor_set)
        shortest = min(len(r[0]) for r in out)
        if shortest < n:
            if n > self._n_live:
                warnings.warn(
                    f"Requested {n} neighbors but only {self._n_live} "
                    "are indexed.")
            else:
                warnings.warn(
                    f"Requested {n} neighbors but some queries found only "
                    f"{shortest} in the probed lists; increase nprobe for "
                    "better coverage.")
        return out
