"""
Device-resident, growable vector store with UID bookkeeping.

Counterpart of ``smqtk_indexing_tpu/ops/store.py:52-581`` (``VectorStore``)
for the float32 and bfloat16 codecs. Vectors live once in a padded (C, d)
tensor on ``device``; the host keeps a float32 mirror (the persistence and
compaction source of truth), a row -> UID list and a UID -> row dict.
Removal flips a validity mask; capacity doubles on growth
(``capacity_for``: 1024 * 2^m rows, so every capacity is a multiple of the
128-row segment) and the store compacts when under half full.

Queries route by metric, on every device and capacity:

- euclidean, inner_product, cosine -> ``ops/fused_scan.flat_topk_fused``
  (the CUDA stage-1 kernel on a card, its plain version on the CPU). The
  kernel reads the row-major matrix, so there is no transposed copy;
  cosine keeps a row-normalised mirror, built on first use after each
  upload.
- hik, chi_square -> ``ops/scan.flat_topk``.

Unlike the JAX store, batch and k are not rounded up to powers of two:
PyTorch has no compile cache to bound.

Device tensors are written in place on mutation (an append costs only
its rows), so a query holds the store lock while it reads them.
"""
from __future__ import annotations

import io
import threading
from typing import Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch.ops import scan
from smqtk_indexing_tpu_torch.ops.device import (
    capacity_for, pad_dim, pad_rows_np, resolve_device,
)
from smqtk_indexing_tpu_torch.ops.fused_scan import (
    FUSED_METRICS, flat_topk_fused, normalized_rows,
)
from smqtk_indexing_tpu_torch.utils.tracing import trace_span

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class VectorStore:
    """
    (N, d) float vector store, queryable with exhaustive top-k on its
    device.

    :param dtype: 'float32' or 'bfloat16'. The compressed codecs ('sq8',
        'pq<M>', 'opq<M>') are a later slice of the port.
    :param device: torch device of the tensors ('cuda' raises when no card
        is present).
    """

    def __init__(self, dtype: str = "float32", device="cuda"):
        if dtype not in _DTYPES:
            raise ValueError(
                f"dtype {dtype!r} is not ported yet: this store serves "
                f"{sorted(_DTYPES)}; 'sq8', 'pq<M>' and 'opq<M>' are the "
                "'Codecs' slice of ROADMAP.md (queue 1, item 4).")
        self._dtype_name = dtype
        self._device = resolve_device(device)
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
                self._dev_valid[rows] = False

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
        padded = pad_rows_np(self._host, self._capacity, pad_dim(self._dim))
        sq = np.zeros(self._capacity, dtype=np.float32)
        sq[:n] = np.einsum("ij,ij->i", self._host, self._host)
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:n] = self._valid_host
        self._dev = self._to_dev(padded, _DTYPES[self._dtype_name])
        self._dev_sq = self._to_dev(sq)
        self._dev_norm = torch.sqrt(self._dev_sq)
        self._dev_valid = self._to_dev(valid)
        self._cos_mirror = None

    def _upload_rows(self, start: int, mat: np.ndarray) -> None:
        """Append rows [start, start + len(mat)) in place on the device."""
        stop = start + mat.shape[0]
        block = pad_rows_np(mat, mat.shape[0], pad_dim(self._dim))
        self._dev[start:stop] = self._to_dev(block, self._dev.dtype)
        sq = self._to_dev(np.einsum("ij,ij->i", mat, mat)
                          .astype(np.float32))
        self._dev_sq[start:stop] = sq
        self._dev_norm[start:stop] = torch.sqrt(sq)
        self._dev_valid[start:stop] = True
        self._cos_mirror = None

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
            qd = self._to_dev(
                pad_rows_np(q, q.shape[0], pad_dim(self._dim)))
            if metric in FUSED_METRICS:
                if metric == "cosine" and self._cos_mirror is None:
                    self._cos_mirror = normalized_rows(
                        self._dev, self._dev_norm, self._dev.dtype)
                dists, rows = flat_topk_fused(
                    self._dev, self._dev_sq, self._dev_valid, qd, k=k_eff,
                    metric=metric, db_mirror=self._cos_mirror,
                    db_norm=self._dev_norm)
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
