"""
Device-resident, growable vector store with UID bookkeeping.

Counterpart of ``smqtk_indexing_tpu/ops/store.py:52-581`` (``VectorStore``)
for the float32, bfloat16, sq8, pq<M> and opq<M> codecs. Vectors live once
in a padded tensor on ``device`` (rows, or their codes); the host keeps a
float32 mirror (the persistence and compaction source of truth), a row ->
UID list and a UID -> row dict. Removal flips a validity mask; capacity
doubles on growth (``capacity_for``: 1024 * 2^m rows, so every capacity is
a multiple of the 128-row segment) and the store compacts when under half
full. A codec (SQ8 scale and offset; PQ interleave, OPQ rotation and
codebooks) trains at ``build`` and is kept across capacity growth and
compaction, so added rows encode with it (out-of-range SQ8 values clip).

Queries route by codec and metric, on every device and capacity (the TPU
routing of ``store.py:479-545``):

- float32 / bfloat16, euclidean, inner_product, cosine ->
  ``ops/fused_scan.flat_topk_fused`` (the CUDA stage-1 kernel on a card,
  its plain version on the CPU). The kernel reads the row-major matrix,
  so there is no transposed copy; cosine keeps a row-normalised mirror,
  built on first use after each upload. A float32 store's stage 1 takes
  ``SMQTK_TPU_STAGE1`` (``ops/device.stage1_precision``, the JAX store's
  switch, same name and values), read per query: ``split3`` by default,
  ``native`` or ``highest``.
- float32 / bfloat16, hik, chi_square -> ``ops/scan.flat_topk``.
- ``SMQTK_TPU_NO_FUSED`` set (the JAX store's opt-out, same name, read
  per query) takes K1 out of both routes: float32 / bfloat16 go to
  ``ops/scan.flat_topk`` for every metric, and sq8 runs ``sq8_topk``'s
  streamed stage 1 (``fused=False``).
- sq8 -> ``ops/sq8.sq8_topk``; euclidean and inner_product at a capacity
  past one 65,536-row block (and a multiple of 4096) run its stage 1
  through K1's int8 form over the row-major codes, or, with
  ``SMQTK_TPU_SQ8_I8DOT=1`` in the environment at query time (the JAX
  store's switch, same name), through K1's int8 x int8 form.
- pq<M> / opq<M> -> ``ops/pq.pq_topk`` over codec-grid queries. hik is
  refused under OPQ (a rotation does not preserve it).

Under a mesh (``VectorStore(mesh=)``) the device tensors are row-sharded
and every query takes the JAX package's sharded routes
(``store.py:482-534``): ``parallel.sharded_scan.sharded_flat_topk``
(``ops/scan.flat_topk`` a shard, not K1), ``sharded_sq8_topk``
(``sq8_topk``'s streamed stage 1) and ``sharded_pq_topk``. A mutation
places the shards anew.

Unlike the JAX store, batch and k are not rounded up to powers of two:
PyTorch has no compile cache to bound.

Device tensors are written in place on mutation (an append costs only
its rows), so a query holds the store lock while it reads them.
"""
from __future__ import annotations

import io
import math
import os
import threading
from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops import scan
from smqtk_indexing_tpu_torch.ops.device import (
    capacity_for, pad_dim, pad_rows_np, resolve_device, stage1_precision,
    tpu_kernel_enabled,
)
from smqtk_indexing_tpu_torch.ops.fused_scan import (
    FUSED_METRICS, exact_dists, flat_topk_fused, normalized_rows,
)
from smqtk_indexing_tpu_torch.ops.pq import (
    pq_build_store, pq_encode_np, pq_m, pq_prep_queries, pq_rotate,
    pq_row_stats, pq_topk,
)
from smqtk_indexing_tpu_torch.ops.sq8 import (
    DEFAULT_CHUNK, sq8_build_store, sq8_encode_np, sq8_row_stats, sq8_topk,
)
from smqtk_indexing_tpu_torch.parallel.mesh import shard_rows
from smqtk_indexing_tpu_torch.parallel.sharded_scan import (
    sharded_flat_topk, sharded_pq_topk, sharded_sq8_topk,
)
from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS, trace_span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

#: The TPU kernel's row tile: the SQ8 store takes the fused stage 1 only at
#: capacities that are multiples of it (``store.py:90-103``).
_FUSED_TILE = 4096


class VectorStore:
    """
    (N, d) vector store, queryable with exhaustive top-k on its device.

    :param dtype: 'float32', 'bfloat16', 'sq8' (one int8 code a dim),
        'pq<M>' (M bytes a vector) or 'opq<M>' (PQ behind a learned OPQ
        rotation).
    :param device: torch device of the tensors ('cuda' raises when no card
        is present).
    :param mesh: Optional ``parallel.mesh.Mesh``: the tensors are
        row-sharded over it (capacities are powers of two, so any mesh
        divides them) and ``device`` is ignored.
    """

    def __init__(self, dtype: str = "float32", device="cuda", mesh=None):
        if dtype not in _DTYPES and dtype != "sq8" and pq_m(dtype) is None:
            raise ValueError(
                f"dtype must be one of {sorted(_DTYPES) + ['sq8']}, "
                f"'pq<M>' or 'opq<M>', got {dtype!r}")
        self._dtype_name = dtype
        self._mesh = mesh
        self._device = mesh.first if mesh is not None \
            else resolve_device(device)
        self._lock = threading.RLock()
        self._clear_state()

    # ------------------------------------------------------------------
    # state
    # ------------------------------------------------------------------
    def _clear_state(self) -> None:
        self._dim: Optional[int] = None
        self._host: Optional[np.ndarray] = None      # (n_rows, d) f32
        self._valid_host: Optional[np.ndarray] = None  # (n_rows,) bool
        self._row2uid: List[Hashable] = []
        self._uid2row: dict = {}
        self._n_live = 0
        # device side
        self._dev: Optional[torch.Tensor] = None
        self._dev_sq: Optional[torch.Tensor] = None
        self._dev_norm: Optional[torch.Tensor] = None
        self._dev_valid: Optional[torch.Tensor] = None
        self._cos_mirror: Optional[torch.Tensor] = None
        self._capacity = 0
        # Codec, trained at build and kept across growth and compaction:
        # SQ8 (a, b) numpy over the true dims, with their padded tensors;
        # PQ (perm, rot | None, codebooks) numpy, with the codebook tensor.
        self._codec = None
        self._sq8_a = self._sq8_b = None
        self._pq_cb_dev = None

    @property
    def dim(self) -> Optional[int]:
        return self._dim

    @property
    def n_valid(self) -> int:
        return self._n_live

    @property
    def capacity(self) -> int:
        return self._capacity

    def uids(self) -> List[Hashable]:
        """Live UIDs in row order."""
        with self._lock:
            if self._host is None:
                return []
            return [u for u, v in zip(self._row2uid, self._valid_host) if v]

    def has_uid(self, uid: Hashable) -> bool:
        with self._lock:
            return uid in self._uid2row

    def uid_to_row(self) -> dict:
        """Snapshot of the live UID -> storage-row mapping."""
        with self._lock:
            return dict(self._uid2row)

    def vector(self, uid: Hashable) -> np.ndarray:
        """:raises KeyError: unknown UID."""
        with self._lock:
            return self._host[self._uid2row[uid]]

    def clear(self) -> None:
        with self._lock:
            self._clear_state()

    # ------------------------------------------------------------------
    # mutation
    # ------------------------------------------------------------------
    def build(self, mat: np.ndarray, uids: Sequence[Hashable]) -> None:
        """Replace all contents with the given (n, d) matrix and UIDs."""
        src = mat
        mat = np.ascontiguousarray(np.atleast_2d(mat), dtype=np.float32)
        if isinstance(src, np.ndarray) and np.shares_memory(mat, src):
            # The host mirror is the persistence/compaction source of
            # truth: never alias caller-owned memory.
            mat = mat.copy()
        if mat.shape[0] != len(uids):
            raise ValueError("Row count does not match UID count.")
        if len(set(uids)) != len(uids):
            raise ValueError("Duplicate UIDs in build input.")
        with self._lock:
            self._clear_state()
            self._dim = int(mat.shape[1])
            self._host = mat
            self._valid_host = np.ones(mat.shape[0], dtype=bool)
            self._row2uid = list(uids)
            self._uid2row = {u: i for i, u in enumerate(uids)}
            self._n_live = mat.shape[0]
            self._upload_full()

    def load_state(self, matrix: np.ndarray, uids: Sequence[Hashable],
                   valid: Optional[np.ndarray] = None) -> None:
        """
        Adopt a store's host state row for row: the (n, d) f32 matrix, the
        row -> UID list and the liveness mask (default all live), as the
        JAX ``VectorStore`` keeps them (``_host``, ``_row2uid``,
        ``_valid_host``). Row ids of query results then match that store's.
        """
        mat = np.array(np.atleast_2d(matrix), dtype=np.float32, order="C")
        uids = list(uids)
        valid = np.ones(len(uids), dtype=bool) if valid is None \
            else np.array(valid, dtype=bool)
        if not mat.shape[0] == len(uids) == valid.shape[0]:
            raise ValueError("matrix, uids and valid disagree in length.")
        live = [u for u, v in zip(uids, valid) if v]
        if len(set(live)) != len(live):
            raise ValueError("Duplicate live UIDs in state.")
        with self._lock:
            self._clear_state()
            if not live:
                return
            self._dim = int(mat.shape[1])
            self._host = mat
            self._valid_host = valid
            self._row2uid = uids
            self._uid2row = {u: i for i, u in enumerate(uids) if valid[i]}
            self._n_live = len(live)
            self._upload_full()

    def add(self, mat: np.ndarray, uids: Sequence[Hashable]) -> None:
        """
        Append rows (UIDs must be new; replacing an existing UID is the
        caller's policy to implement via remove+add).
        """
        mat = np.ascontiguousarray(np.atleast_2d(mat), dtype=np.float32)
        if mat.shape[0] != len(uids):
            raise ValueError("Row count does not match UID count.")
        with self._lock:
            if self._host is None:
                self.build(mat, uids)
                return
            if mat.shape[1] != self._dim:
                raise ValueError(
                    f"Dim mismatch: store={self._dim}, input={mat.shape[1]}")
            if len(set(uids)) != len(uids):
                raise ValueError("Duplicate UIDs in add input.")
            for u in uids:
                if u in self._uid2row:
                    raise ValueError(f"UID already present: {u!r}")
            start = self._host.shape[0]
            self._host = np.concatenate([self._host, mat], axis=0)
            self._valid_host = np.concatenate(
                [self._valid_host, np.ones(mat.shape[0], dtype=bool)])
            for i, u in enumerate(uids):
                self._uid2row[u] = start + i
                self._row2uid.append(u)
            self._n_live += mat.shape[0]
            if self._host.shape[0] > self._capacity:
                self._upload_full()
            else:
                self._upload_rows(start, mat)

    def remove(self, uids: Sequence[Hashable]) -> None:
        """
        Mask out rows for the given UIDs.

        :raises KeyError: any UID unknown; nothing is removed in that case.
        """
        uids = list(dict.fromkeys(uids))
        with self._lock:
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
                self._clear_state()
                return
            if self._n_live < self._host.shape[0] // 2 \
                    and self._host.shape[0] > 1024:
                self._compact()
            else:
                self._upload_valid(rows)

    def _compact(self) -> None:
        keep = np.flatnonzero(self._valid_host)
        self._host = np.ascontiguousarray(self._host[keep])
        self._row2uid = [self._row2uid[i] for i in keep]
        self._uid2row = {u: i for i, u in enumerate(self._row2uid)}
        self._valid_host = np.ones(self._host.shape[0], dtype=bool)
        self._upload_full()

    # ------------------------------------------------------------------
    # device sync
    # ------------------------------------------------------------------
    def _to_dev(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        return torch.from_numpy(a).to(device=self._device, dtype=dtype)

    def _upload_full(self) -> None:
        n = self._host.shape[0]
        self._capacity = capacity_for(n)
        d_pad = pad_dim(self._dim)
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:n] = self._valid_host
        self._dev_valid = self._to_dev(valid)
        self._cos_mirror = None
        if self._dtype_name == "sq8":
            (self._sq8_a, self._sq8_b, self._dev, self._dev_sq,
             self._dev_norm) = sq8_build_store(
                self._host, self._valid_host, self._capacity, d_pad,
                self._dim, self._device, codec=self._codec)
            self._codec = (self._sq8_a[:self._dim].cpu().numpy(),
                           self._sq8_b[:self._dim].cpu().numpy())
        elif pq_m(self._dtype_name) is not None:
            perm, rot, cb, self._pq_cb_dev, self._dev, self._dev_sq = \
                pq_build_store(self._host, self._valid_host, self._capacity,
                               d_pad, pq_m(self._dtype_name), self._device,
                               rotate=pq_rotate(self._dtype_name),
                               codec=self._codec)
            self._codec = (perm, rot, cb)
            self._dev_norm = torch.sqrt(torch.clamp(self._dev_sq, min=0.0))
        elif self._mesh is not None:
            # Float rows go from host memory straight to each shard.
            sq = np.zeros(self._capacity, dtype=np.float32)
            sq[:n] = np.einsum("ij,ij->i", self._host, self._host)
            rows = torch.from_numpy(
                pad_rows_np(self._host, self._capacity, d_pad))
            self._dev = shard_rows(self._mesh,
                                   rows.to(_DTYPES[self._dtype_name]))
            del rows
            self._dev_sq = shard_rows(self._mesh, sq)
            self._dev_norm = [torch.sqrt(t) for t in self._dev_sq]
            self._dev_valid = shard_rows(self._mesh, valid)
            return
        else:
            padded = pad_rows_np(self._host, self._capacity, d_pad)
            sq = np.zeros(self._capacity, dtype=np.float32)
            sq[:n] = np.einsum("ij,ij->i", self._host, self._host)
            self._dev = self._to_dev(padded, _DTYPES[self._dtype_name])
            self._dev_sq = self._to_dev(sq)
            self._dev_norm = torch.sqrt(self._dev_sq)
            return
        if self._mesh is not None:
            # Codes are built on the mesh's first device, then sharded.
            self._dev, self._dev_sq, self._dev_norm, self._dev_valid = (
                shard_rows(self._mesh, t) for t in (
                    self._dev, self._dev_sq, self._dev_norm,
                    self._dev_valid))

    def _upload_valid(self, rows: List[int]) -> None:
        """Mark removed ``rows`` dead on the device (under a mesh, the
        shards' masks are placed anew)."""
        if self._mesh is not None:
            valid = np.zeros(self._capacity, dtype=bool)
            valid[:self._host.shape[0]] = self._valid_host
            self._dev_valid = shard_rows(self._mesh, valid)
        else:
            self._dev_valid[rows] = False

    def _upload_rows(self, start: int, mat: np.ndarray) -> None:
        """Append rows [start, start + len(mat)) in place on the device;
        a codec store encodes them with its build-time codec. Under a
        mesh the shards are placed anew."""
        if self._mesh is not None:
            self._upload_full()
            return
        stop = start + mat.shape[0]
        block = pad_rows_np(mat, mat.shape[0], pad_dim(self._dim))
        if self._dtype_name == "sq8":
            codes = np.zeros(block.shape, dtype=np.int8)
            codes[:, :self._dim] = sq8_encode_np(mat, *self._codec)
            codes = self._to_dev(codes)
            sq, nrm = sq8_row_stats(codes, self._sq8_a, self._sq8_b)
        elif pq_m(self._dtype_name) is not None:
            perm, rot, cb = self._codec
            codes = self._to_dev(pq_encode_np(
                pq_prep_queries(block, perm, rot), cb, device=self._device))
            sq = pq_row_stats(codes, self._pq_cb_dev)
            nrm = torch.sqrt(torch.clamp(sq, min=0.0))
        else:
            codes = self._to_dev(block, self._dev.dtype)
            sq = self._to_dev(np.einsum("ij,ij->i", mat, mat)
                              .astype(np.float32))
            nrm = torch.sqrt(sq)
        self._dev[start:stop] = codes
        self._dev_sq[start:stop] = sq
        self._dev_norm[start:stop] = nrm
        self._dev_valid[start:stop] = True
        self._cos_mirror = None

    def _fused_eligible(self, metric: str) -> bool:
        """A float32 / bfloat16 query runs ``flat_topk_fused`` (K1) for
        the matmul-form metrics unless ``SMQTK_TPU_NO_FUSED`` is set
        (``store.py:76-87``), read per query."""
        return (tpu_kernel_enabled("SMQTK_TPU_NO_FUSED")
                and metric in FUSED_METRICS)

    def _sq8_fused_eligible(self, metric: str) -> bool:
        """The SQ8 scan's stage 1 runs through K1's int8 form
        (``store.py:89-103``, the TPU routing): ``SMQTK_TPU_NO_FUSED``
        unset, euclidean or inner_product, a capacity past one streamed
        block and a multiple of the TPU kernel's row tile."""
        return (self._dtype_name == "sq8"
                and tpu_kernel_enabled("SMQTK_TPU_NO_FUSED")
                and metric in ("euclidean", "inner_product")
                and self._capacity > DEFAULT_CHUNK
                and self._capacity % _FUSED_TILE == 0)

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    @trace_span("store.knn")
    def knn(self, q: np.ndarray, k: int, metric: str = "euclidean"
            ) -> Tuple[np.ndarray, List[List[Hashable]], np.ndarray]:
        """
        Exhaustive top-k for a (B, d) query batch. The results are copied
        back to the host, so the ``store.knn`` span's seconds hold the
        device work too.

        :return: (dists (B, k') float32 ascending, per-query UID lists,
            rows (B, k') int64) where k' = min(k, live rows).
        """
        if metric not in scan.METRICS:
            raise ValueError(f"Unknown metric {metric!r}; must be one of "
                             f"{scan.METRICS}")
        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        with self._lock:
            if self._host is None:
                raise ValueError("Store is empty.")
            if q.shape[1] != self._dim:
                raise ValueError(
                    f"Query dim {q.shape[1]} != store dim {self._dim}")
            k_eff = min(k, self._n_live)
            q_pad = pad_rows_np(q, q.shape[0], pad_dim(self._dim))
            qd = self._to_dev(q_pad)
            if pq_m(self._dtype_name) is not None:
                perm, rot, _ = self._codec
                if rot is not None and metric == "hik":
                    # min() is not rotation invariant: OPQ serves the
                    # matmul-form metrics only, as FAISS's OPQ does.
                    raise ValueError("metric 'hik' is not supported with "
                                     "OPQ (rotation-variant); use 'pq<M>'")
            if self._mesh is not None:
                dists, rows = self._knn_sharded(q_pad, k_eff, metric)
            elif pq_m(self._dtype_name) is not None:
                dists, rows = pq_topk(
                    self._dev, self._pq_cb_dev, self._dev_sq,
                    self._dev_valid,
                    self._to_dev(pq_prep_queries(q_pad, perm, rot)),
                    k=k_eff, metric=metric)
            elif self._dtype_name == "sq8":
                fused = self._sq8_fused_eligible(metric)
                # The JAX store's opt-in int8 x int8 stage 1
                # (store.py:504-514), read per query so that a toggle
                # takes effect at the next call.
                i8dot = (fused and os.environ.get("SMQTK_TPU_SQ8_I8DOT")
                         == "1")
                dists, rows = sq8_topk(
                    self._dev, self._sq8_a, self._sq8_b, self._dev_sq,
                    self._dev_norm, self._dev_valid, qd, k=k_eff,
                    metric=metric, fused=fused, i8dot=i8dot)
            elif self._fused_eligible(metric):
                if metric == "cosine" and self._cos_mirror is None:
                    self._cos_mirror = normalized_rows(
                        self._dev, self._dev_norm, self._dev.dtype)
                # The JAX store's stage-1 dot mode (store.py:535-541),
                # read per query so that a change takes effect at the next
                # call.
                dists, rows = flat_topk_fused(
                    self._dev, self._dev_sq, self._dev_valid, qd, k=k_eff,
                    metric=metric, db_mirror=self._cos_mirror,
                    db_norm=self._dev_norm, precision=stage1_precision())
            else:
                dists, rows = scan.flat_topk(
                    self._dev, self._dev_sq, self._dev_norm,
                    self._dev_valid, qd, k=k_eff, metric=metric)
            dists = dists.cpu().numpy()
            rows = rows.cpu().numpy()
            # Borrow, don't copy: the list only grows in place under the
            # lock and compaction replaces the object.
            row2uid = self._row2uid
        # r >= 0 guard: -1 padding must fail soft (skip), not resolve to
        # the last row via Python negative indexing.
        uid_lists = [[row2uid[r] for r in row if r >= 0]
                     for row in rows.tolist()]
        return dists, uid_lists, rows

    def _knn_sharded(self, q_pad: np.ndarray, k: int, metric: str):
        """The JAX store's routes under a mesh (``store.py:482-534``): the
        plain per-shard scans, never K1."""
        mesh = self._mesh
        if pq_m(self._dtype_name) is not None:
            perm, rot, _ = self._codec
            return sharded_pq_topk(
                mesh, self._dev, self._pq_cb_dev, self._dev_sq,
                self._dev_valid, pq_prep_queries(q_pad, perm, rot), k=k,
                metric=metric)
        if self._dtype_name == "sq8":
            return sharded_sq8_topk(
                mesh, self._dev, self._sq8_a, self._sq8_b, self._dev_sq,
                self._dev_norm, self._dev_valid, q_pad, k=k, metric=metric)
        return sharded_flat_topk(
            mesh, self._dev, self._dev_sq, self._dev_norm, self._dev_valid,
            q_pad, k=k, metric=metric)

    # ------------------------------------------------------------------
    # persistence
    # ------------------------------------------------------------------
    def to_bytes(self) -> bytes:
        """Serialize live rows + UIDs (compact form); the bytes are those
        of the JAX store's ``to_bytes`` for the same contents."""
        with self._lock:
            bio = io.BytesIO()
            if self._host is None:
                np.savez(bio, empty=np.array(True))
            else:
                keep = np.flatnonzero(self._valid_host)
                np.savez(
                    bio,
                    matrix=self._host[keep],
                    uids=np.array([self._row2uid[i] for i in keep],
                                  dtype=object),
                )
            return bio.getvalue()

    def from_bytes(self, data: bytes) -> None:
        bio = io.BytesIO(data)
        with np.load(bio, allow_pickle=True) as z:
            if "empty" in z:
                self.clear()
                return
            mat = z["matrix"]
            uids = list(z["uids"])
        self.build(mat, uids)


class HostStreamedVectorStore (VectorStore):
    """
    The tier past the card's memory (``store.py:584-690``): the database
    lives in host memory only, and each query batch streams it through
    one device in ``BLOCK_ROWS`` row blocks, runs the exact flat scan
    ``ops/scan.flat_topk`` on each block (not K1, as in the JAX store) and
    merges the blocks' (B, k) winners by a stable sort, so a tie goes to
    the lowest block. Every block's distances are already exact, so the
    merge is the exact global top-k. Capacity is bounded by host memory;
    each batch pays one host-to-device copy of the whole matrix.

    On a card, block i + 1's copy overlaps block i's scan: the host copies
    a block into one of two pinned staging buffers, reused only once a
    CUDA event says its last copy to the card is done; a side stream
    copies it to the card, and the scanning stream takes it with
    ``wait_stream`` / ``record_stream``. The feature dim and the last
    block's rows are padded on the card. Row norms are the device store's
    (``np.einsum`` over the host rows, kept on the host), so each block's
    scan sees the operands the device store holds. On the CPU the same
    code runs without streams. The liveness mask is snapshotted per query,
    under the lock; queries stream one at a time (the staging buffers are
    shared) while mutations go on.

    :param dtype: 'float32' or 'bfloat16' (a codec would re-encode every
        batch).
    :param device: the one device the blocks stream through.
    :param mesh: must be None.
    :param block_rows: rows a block, a power of two >= 1024 (default
        ``BLOCK_ROWS``).
    """

    #: Rows a streamed block.
    BLOCK_ROWS = 1 << 20

    def __init__(self, dtype: str = "float32", device="cuda", mesh=None,
                 block_rows: Optional[int] = None):
        if mesh is not None:
            raise ValueError(
                "HostStreamedVectorStore streams through ONE device; use "
                "the base VectorStore with n_devices for mesh sharding.")
        if dtype not in _DTYPES:
            raise ValueError(
                "Host streaming serves float32/bfloat16 (compressed codecs "
                "are HBM-resident tiers; combining them with host "
                "streaming would re-encode per batch).")
        super().__init__(dtype=dtype, device=device)
        if block_rows is not None:
            if block_rows & (block_rows - 1) or block_rows < 1024:
                raise ValueError("block_rows must be a power of two "
                                 ">= 1024.")
            self.BLOCK_ROWS = block_rows
        self._stream_lock = threading.Lock()
        self._staging = None

    def _clear_state(self) -> None:
        super()._clear_state()
        self._sq_host: Optional[np.ndarray] = None

    # No device mirror: the blocks stream per query batch.
    def _upload_full(self) -> None:
        self._capacity = capacity_for(self._host.shape[0])
        self._sq_host = np.einsum("ij,ij->i", self._host, self._host)

    def _upload_rows(self, start: int, mat: np.ndarray) -> None:
        self._capacity = capacity_for(self._host.shape[0])
        self._sq_host = np.concatenate(
            [self._sq_host[:start],
             np.einsum("ij,ij->i", mat, mat).astype(np.float32)])

    def _upload_valid(self, rows: List[int]) -> None:
        pass

    def _staging_buffers(self, block: int, d: int):
        """Two pinned (block, d) f32 row buffers with their norm and
        liveness buffers, and the event of each one's last copy."""
        key = (block, d)
        if self._staging is None or self._staging[0] != key:
            self._staging = (key, [
                {"rows": torch.empty((block, d), pin_memory=True),
                 "sq": torch.empty((block,), pin_memory=True),
                 "valid": torch.empty((block,), dtype=torch.bool,
                                      pin_memory=True),
                 "done": None} for _ in range(2)])
        return self._staging[1]

    @trace_span("store.knn")
    def knn(self, q: np.ndarray, k: int, metric: str = "euclidean"
            ) -> Tuple[np.ndarray, List[List[Hashable]], np.ndarray]:
        if metric not in scan.METRICS:
            raise ValueError(f"Unknown metric {metric!r}; must be one of "
                             f"{scan.METRICS}")
        q = np.atleast_2d(np.asarray(q, dtype=np.float32))
        host, sq_host, valid_host, row2uid, n_live = self.snapshot()
        if q.shape[1] != host.shape[1]:
            raise ValueError(
                f"Query dim {q.shape[1]} != store dim {host.shape[1]}")
        k_eff = min(k, n_live)
        qd = self.device_queries(q)
        parts = []
        with self._stream_lock:
            for lo, mat, sq, va in self.blocks(host, sq_host, valid_host):
                parts.append(self.scan_block(lo, mat, sq, va, qd, k_eff,
                                             metric))
        dists = torch.cat([dd for dd, _ in parts], dim=1)
        rows = torch.cat([rr for _, rr in parts], dim=1)
        # Ties go to the lowest block, as np.argsort(kind="stable").
        dists, sel = torch.sort(dists, dim=1, stable=True)
        rows = torch.gather(rows, 1, sel[:, :k_eff]).cpu().numpy()
        dists = dists[:, :k_eff].cpu().numpy()
        uid_lists = [[row2uid[r] for r in row if r >= 0]
                     for row in rows.tolist()]
        return dists, uid_lists, rows

    def snapshot(self):
        """What one query streams, taken under the lock: (host rows, their
        squared norms, a copy of the liveness mask, the row-to-UID list,
        the live count). ``remove`` flips the mask in place, so it is
        copied; the rows and norms are only ever replaced whole, so a
        reference is a snapshot (a copy could be tens of GB)."""
        with self._lock:
            if self._host is None:
                raise ValueError("Store is empty.")
            return (self._host, self._sq_host, self._valid_host.copy(),
                    self._row2uid, self._n_live)

    def device_queries(self, q: np.ndarray) -> torch.Tensor:
        """(B, d) f32 queries on the device, padded to the blocks' dim."""
        qd = torch.zeros((q.shape[0], pad_dim(q.shape[1])),
                         dtype=torch.float32, device=self._device)
        qd[:, :q.shape[1]] = torch.from_numpy(q).to(self._device)
        return qd

    def blocks(self, host, sq_host, valid_host):
        """
        Each block of a :meth:`snapshot` on the device, padded as its scan
        takes it: yields (first row, rows (n_pad, d_pad), squared norms,
        liveness). On a card the host copies a block into a pinned
        staging buffer (span ``host_stream.stage``) and a side stream
        copies it to the card while the caller scans the block before.
        Counters ``host_stream.blocks`` and ``host_stream.bytes`` count
        what was streamed.
        """
        dev = self._device
        cuda = dev.type == "cuda"
        n, d = host.shape
        block = min(self.BLOCK_ROWS, capacity_for(n))
        d_pad = pad_dim(d)
        dtype = _DTYPES[self._dtype_name]
        if cuda:
            staging = self._staging_buffers(block, d)
            main = torch.cuda.current_stream(dev)
            side = torch.cuda.Stream(dev)
        for i, lo in enumerate(range(0, n, block)):
            hi = min(lo + block, n)
            rows_n = hi - lo
            pad_n = block if rows_n > block // 2 or lo > 0 \
                else capacity_for(rows_n)
            parts = (host[lo:hi], sq_host[lo:hi], valid_host[lo:hi])
            if cuda:
                raw, sq_blk, va_blk = self._stage(staging[i % 2], parts,
                                                  side, main)
            else:
                raw, sq_blk, va_blk = (torch.from_numpy(p) for p in parts)
            COUNTERS.add("host_stream.blocks")
            COUNTERS.add("host_stream.bytes", sum(p.nbytes for p in parts))
            mat = torch.zeros((pad_n, d_pad), dtype=dtype, device=dev)
            mat[:rows_n, :d] = raw
            sq = torch.zeros((pad_n,), dtype=torch.float32, device=dev)
            sq[:rows_n] = sq_blk
            va = torch.zeros((pad_n,), dtype=torch.bool, device=dev)
            va[:rows_n] = va_blk
            del raw, sq_blk, va_blk
            yield lo, mat, sq, va

    def _stage(self, buf, parts, side, main):
        """One block's host arrays through pinned ``buf`` to the card on
        stream ``side``, handed to stream ``main``."""
        rows_n = parts[0].shape[0]
        with trace_span("host_stream.stage"):
            if buf["done"] is not None:
                buf["done"].synchronize()
            for name, arr in zip(("rows", "sq", "valid"), parts):
                buf[name][:rows_n].copy_(torch.from_numpy(arr))
        with torch.cuda.stream(side):
            got = [buf[name][:rows_n].to(self._device, non_blocking=True)
                   for name in ("rows", "sq", "valid")]
            buf["done"] = torch.cuda.Event()
            buf["done"].record(side)
        main.wait_stream(side)
        for t in got:
            t.record_stream(main)
        return got

    def scan_block(self, lo, mat, sq, va, qd, k_eff, metric):
        """
        One block's exact top-k (``scan.flat_topk``): (dists, rows offset
        by ``lo``), +inf / -1 past its live rows. Where the device store
        would take K1 for inner_product or cosine, it finishes those by
        K1's elementwise formula (``fused_scan.exact_dists``), so the two
        stores give the same bits.
        """
        nrm = torch.sqrt(sq)
        dd, rr = scan.flat_topk(mat, sq, nrm, va, qd,
                                k=min(k_eff, mat.shape[0]), metric=metric)
        if metric in ("inner_product", "cosine") \
                and self._fused_eligible(metric):
            at = torch.clamp(rr, min=0)
            exact = exact_dists(metric, mat[at].float(), qd,
                                torch.sqrt((qd * qd).sum(-1)), nrm[at])
            dd, order = torch.sort(torch.where(rr >= 0, exact, math.inf),
                                   dim=1, stable=True)
            rr = torch.gather(rr, 1, order)
        return dd, torch.where(rr >= 0, rr + lo, -1)
