"""
Packed-code Hamming top-k and the device-resident code store: the port of
``smqtk_indexing_tpu/ops/hamming.py``.

Hash codes are ``(N, ceil(bits/32))`` packed words (``utils/bits``'s
``pack_bit_vectors_u32``), held on the device as ``int32`` tensors with the
same bits: PyTorch has no popcount, and most of its operators refuse
``uint32``. :func:`popcount32` counts a word's bits by SWAR on ``int64``.

``hamming_topk`` is XLA array code in the JAX package (``:60-104``), not
a Pallas kernel, so its counterpart here is plain PyTorch: it streams row
blocks of at most ``chunk`` rows with a running top-k and never builds the
(B, N) distance matrix. Its order is the JAX function's: ascending
distance, then ascending row (``lax.top_k`` is stable; ``torch.topk`` is
not, so the selection runs on one int64 key, distance then row).

``CodeStore`` keeps the JAX store's three single-device routes
(``:382-461``):

- ``host_rows <= HOST_SCAN_MAX``: the host scan through the native
  library (``native.hamming_topk``), over the host mirror;
- the ±1 route, when the capacity is at least ``MXU_SCAN_MIN``, a multiple
  of ``fused_scan.TILE_N``, and ``SMQTK_TPU_NO_MXU_HAMMING`` is unset: the
  codes as a ±1 bf16 mirror, bits padded to a multiple of 128, scanned by
  ``fused_scan.flat_topk_fused``, which runs K1's bf16 form
  (``pallas_scan.segment_minima``; ``csrc/segment_minima_wgmma.cu`` on the
  card). The squared L2 distance between ±1 vectors is exactly 4x their
  Hamming distance, and every product and f32 sum is exact, so
  ``round(d^2 / 4)`` is the Hamming distance. Rows may differ from the
  other routes only among rows tied at the k-th distance. No transposed
  mirror is built: the port's stage 1 scans the row-major mirror itself;
- otherwise the streamed XOR route, :func:`hamming_topk`.

The switch is read per query through ``ops/device.tpu_kernel_enabled``,
which reads only the switch: a CPU tensor takes K1's plain version along
the same route.

Under a mesh (``CodeStore(mesh=)``, ``hamming.py:290-293, 325-327,
420-432``) every query takes the per-shard XOR route and the k-sized
merge, whatever the store's size.
"""
from __future__ import annotations

import io
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from smqtk_indexing_tpu_torch import native
from smqtk_indexing_tpu_torch.ops import fused_scan
from smqtk_indexing_tpu_torch.ops.device import (
    capacity_for, pow2_at_least, resolve_device, round_up,
    tpu_kernel_enabled,
)
from smqtk_indexing_tpu_torch.parallel.mesh import shard_rows
from smqtk_indexing_tpu_torch.utils import bits as bits_util
from smqtk_indexing_tpu_torch.utils.tracing import trace_span

#: Rows per streamed block (codes are narrow, so blocks can be large).
DEFAULT_CHUNK = 262144

#: Below this many code rows the host popcount scan (native C++ when
#: available) serves the query.
HOST_SCAN_MAX = 2048

#: From this capacity on, queries take the ±1 route through K1's bf16 form.
MXU_SCAN_MIN = 16384

#: Sentinel distance for invalid (masked / padded) rows. Larger than any
#: real Hamming distance (codes are at most a few thousand bits).
INVALID = 2 ** 30

#: Cap on the bytes of one (B, rows) int64 block of the XOR scan: a block
#: holds fewer than ``chunk`` rows when the batch is large.
BLOCK_BYTES = 1 << 28


def words_to_tensor(packed: np.ndarray, device) -> torch.Tensor:
    """(n, W) uint32 packed words -> an int32 tensor on ``device`` holding
    the same bits."""
    a = np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32)
    return torch.from_numpy(a).to(device)


def popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 (or int64 holding 32 bits)
    tensor, as an int64 tensor: SWAR, on int64 so that no step
    overflows."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def block_hamming(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(B, W) queries vs (C, W) codes, int32 words -> (B, C) int64
    Hamming distances, one word at a time."""
    d = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.int64,
                    device=x.device)
    for w in range(x.shape[1]):
        d += popcount32(q[:, w, None] ^ x[None, :, w])
    return d


def hamming_topk(db: torch.Tensor, valid: torch.Tensor, q: torch.Tensor,
                 *, k: int, chunk: int = DEFAULT_CHUNK
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """
    Exhaustive Hamming top-k over packed codes on one device.

    :param db: (N, W) int32 packed codes (rows past the live set
        arbitrary).
    :param valid: (N,) bool row-liveness mask.
    :param q: (B, W) int32 packed query codes.
    :param k: neighbours per query.
    :param chunk: most rows a streamed block holds.
    :return: (dists (B, k) int32 ascending, rows (B, k) int32); ties in
        ascending row order; slots past the valid rows hold ``INVALID`` /
        row -1.
    """
    n = db.shape[0]
    b = q.shape[0]
    step = max(1, min(chunk, BLOCK_BYTES // (8 * max(b, 1))))
    best = None
    for lo in range(0, n, step):
        hi = min(lo + step, n)
        d = block_hamming(q, db[lo:hi])
        d = torch.where(valid[None, lo:hi], d, INVALID)
        # One int64 key, distance then row: an exact total order.
        key = (d << 32) | torch.arange(lo, hi, device=db.device)
        if best is not None:
            key = torch.cat([best, key], dim=1)
        best = torch.topk(key, min(k, key.shape[1]), dim=1, largest=False,
                          sorted=True).values
    dists = (best >> 32).int()
    rows = torch.where(dists >= INVALID, -1, (best & 0xFFFFFFFF).int())
    if dists.shape[1] < k:
        pad = k - dists.shape[1]
        dists = torch.nn.functional.pad(dists, (0, pad), value=INVALID)
        rows = torch.nn.functional.pad(rows, (0, pad), value=-1)
    return dists, rows


class CodeStore:
    """
    Device-resident store of *unique* packed hash codes with int-key
    bookkeeping (host dict code-int -> row), queryable with Hamming top-k.

    The host mirror (compact uint32 matrix) is the persistence and
    compaction source of truth; removal is a validity-mask flip with
    compaction when under half full (``ops/hamming.CodeStore`` of the JAX
    package, whose ``to_bytes`` payload this store reads and writes).

    :param bit_length: code length, or None to take it from the first
        build.
    :param mesh: Optional ``parallel.mesh.Mesh``: the packed codes are
        row-sharded over it and every query runs the per-shard XOR scan
        and the k-sized merge (``parallel.sharded_scan.
        sharded_hamming_topk``), as the JAX store does under a mesh (no
        host scan, no ±1 route). ``device`` is then ignored.
    :param device: torch device of the tensors ('cuda' raises when no card
        is present).
    """

    def __init__(self, bit_length: Optional[int] = None, mesh=None,
                 device="cuda"):
        self._lock = threading.RLock()
        self._mesh = mesh
        self._device = mesh.first if mesh is not None \
            else resolve_device(device)
        self._bits = None if bit_length is None else int(bit_length)
        self._clear_state()

    def _clear_state(self) -> None:
        self._host: Optional[np.ndarray] = None      # (n_rows, W) uint32
        self._valid_host: Optional[np.ndarray] = None
        self._row2int: List[int] = []
        self._int2row: Dict[int, int] = {}
        self._n_live = 0
        self._dev: Optional[torch.Tensor] = None     # (cap, W) int32
        self._dev_valid: Optional[torch.Tensor] = None
        self._dev_pm1: Optional[torch.Tensor] = None  # (cap, bits_pad) bf16
        self._dev_pm1_sq: Optional[torch.Tensor] = None  # (cap,) f32 = bits
        self._capacity = 0

    @property
    def bits(self) -> Optional[int]:
        return self._bits

    @property
    def n_valid(self) -> int:
        return self._n_live

    def ints(self) -> List[int]:
        """Live code integers in row order."""
        with self._lock:
            if self._host is None:
                return []
            return [c for c, v in zip(self._row2int, self._valid_host) if v]

    def has_int(self, code: int) -> bool:
        with self._lock:
            return code in self._int2row

    def clear(self) -> None:
        with self._lock:
            self._clear_state()
            self._bits = None

    # ------------------------------------------------------------------
    # mutation (codes given as (n, bits) boolean matrices)
    # ------------------------------------------------------------------
    def _check_bits(self, mat: np.ndarray) -> None:
        if self._bits is None:
            self._bits = int(mat.shape[1])
        elif mat.shape[1] != self._bits:
            raise ValueError(
                f"Hash code bit length {mat.shape[1]} does not match "
                f"index bit length {self._bits}.")

    def build(self, bool_mat: np.ndarray) -> None:
        """Replace contents with the (deduplicated) given codes."""
        bool_mat = np.atleast_2d(np.asarray(bool_mat)).astype(bool)
        with self._lock:
            self._clear_state()
            self._check_bits(bool_mat)
            ints = bits_util.bit_matrix_to_ints(bool_mat)
            seen: Dict[int, int] = {}
            keep_rows = []
            for i, c in enumerate(ints):
                if c not in seen:
                    seen[c] = len(keep_rows)
                    keep_rows.append(i)
            self._host = bits_util.pack_bit_vectors_u32(bool_mat[keep_rows])
            self._valid_host = np.ones(len(keep_rows), dtype=bool)
            self._row2int = [ints[i] for i in keep_rows]
            self._int2row = seen
            self._n_live = len(keep_rows)
            self._upload_full()

    def add(self, bool_mat: np.ndarray) -> None:
        """Add codes, silently skipping ones already present."""
        bool_mat = np.atleast_2d(np.asarray(bool_mat)).astype(bool)
        with self._lock:
            if self._host is None:
                self.build(bool_mat)
                return
            self._check_bits(bool_mat)
            ints = bits_util.bit_matrix_to_ints(bool_mat)
            fresh_rows = []
            fresh_ints = []
            batch_seen = set()
            for i, c in enumerate(ints):
                if c not in self._int2row and c not in batch_seen:
                    batch_seen.add(c)
                    fresh_rows.append(i)
                    fresh_ints.append(c)
            if not fresh_rows:
                return
            packed = bits_util.pack_bit_vectors_u32(bool_mat[fresh_rows])
            start = self._host.shape[0]
            self._host = np.concatenate([self._host, packed], axis=0)
            self._valid_host = np.concatenate(
                [self._valid_host, np.ones(len(fresh_rows), dtype=bool)])
            for j, c in enumerate(fresh_ints):
                self._int2row[c] = start + j
                self._row2int.append(c)
            self._n_live += len(fresh_rows)
            if self._host.shape[0] > self._capacity:
                self._upload_full()
            else:
                self._upload_rows(start, packed)

    def remove(self, bool_mat: np.ndarray) -> None:
        """
        Remove the given codes.

        :raises KeyError: any code not present; nothing removed in that case
            (reference KeyError-non-mutation contract, SMQTK-Indexing
            smqtk_indexing/impls/hash_index/linear.py:184-204).
        """
        bool_mat = np.atleast_2d(np.asarray(bool_mat)).astype(bool)
        with self._lock:
            ints = bits_util.bit_matrix_to_ints(bool_mat)
            rows = []
            for c in ints:
                if c not in self._int2row:
                    raise KeyError(c)
                rows.append(self._int2row[c])
            for c in ints:
                self._int2row.pop(c, None)
            self._valid_host[rows] = False
            self._n_live -= len(set(rows))
            if self._n_live == 0:
                self._clear_state()
                return
            if self._n_live < self._host.shape[0] // 2 \
                    and self._host.shape[0] > 1024:
                self._compact()
            elif self._mesh is not None:
                self._dev_valid = shard_rows(self._mesh, self._valid_pad())
            else:
                self._dev_valid[rows] = False

    def _compact(self) -> None:
        keep = np.flatnonzero(self._valid_host)
        self._host = np.ascontiguousarray(self._host[keep])
        self._row2int = [self._row2int[i] for i in keep]
        self._int2row = {c: i for i, c in enumerate(self._row2int)}
        self._valid_host = np.ones(self._host.shape[0], dtype=bool)
        self._upload_full()

    # ------------------------------------------------------------------
    # device sync
    # ------------------------------------------------------------------
    def _upload_full(self) -> None:
        n = self._host.shape[0]
        self._capacity = capacity_for(n)
        padded = np.zeros((self._capacity, self._host.shape[1]),
                          dtype=np.uint32)
        padded[:n] = self._host
        valid = self._valid_pad()
        self._dev_pm1 = self._dev_pm1_sq = None
        if self._mesh is not None:
            self._dev = shard_rows(self._mesh, padded.view(np.int32))
            self._dev_valid = shard_rows(self._mesh, valid)
            return
        self._dev = words_to_tensor(padded, self._device)
        self._dev_valid = torch.from_numpy(valid).to(self._device)

    def _valid_pad(self) -> np.ndarray:
        """(capacity,) liveness of the host rows, False past them."""
        valid = np.zeros(self._capacity, dtype=bool)
        valid[:self._host.shape[0]] = self._valid_host
        return valid

    def _pm1_rows(self, packed: np.ndarray) -> torch.Tensor:
        """(n, bits_pad) bf16 ±1 rows of packed codes, zero past ``bits``."""
        bits_pad = round_up(self._bits, 128)
        block = np.zeros((packed.shape[0], bits_pad), dtype=np.float32)
        block[:, :self._bits] = bits_util.unpack_bit_vectors_u32(
            packed, self._bits) * 2.0 - 1.0
        return torch.from_numpy(block).to(self._device, torch.bfloat16)

    def _upload_rows(self, start: int, packed: np.ndarray) -> None:
        """Write new rows [start, start + len(packed)) in place, the ±1
        mirror too when it exists (only the new rows are unpacked). Under
        a mesh the shards are placed anew."""
        if self._mesh is not None:
            self._upload_full()
            return
        stop = start + packed.shape[0]
        self._dev[start:stop] = words_to_tensor(packed, self._device)
        self._dev_valid[start:stop] = True
        if self._dev_pm1 is not None:
            self._dev_pm1[start:stop] = self._pm1_rows(packed)
            self._dev_pm1_sq[start:stop] = float(self._bits)

    # ------------------------------------------------------------------
    # ±1 mirror (K1's bf16 form)
    # ------------------------------------------------------------------
    def _mxu_eligible(self) -> bool:
        return (tpu_kernel_enabled("SMQTK_TPU_NO_MXU_HAMMING")
                and self._mesh is None
                and self._capacity >= MXU_SCAN_MIN
                and self._capacity % fused_scan.TILE_N == 0)

    def _ensure_pm1(self) -> None:
        """Build the ±1 bfloat16 mirror lazily (cap, bits padded to 128)
        and its squared norms (``bits`` for every row written)."""
        if self._dev_pm1 is not None:
            return
        n = self._host.shape[0]
        pm1 = torch.zeros((self._capacity, round_up(self._bits, 128)),
                          dtype=torch.bfloat16, device=self._device)
        pm1[:n] = self._pm1_rows(self._host)
        sq = torch.zeros(self._capacity, dtype=torch.float32,
                         device=self._device)
        sq[:n] = float(self._bits)
        self._dev_pm1, self._dev_pm1_sq = pm1, sq

    def _knn_mxu(self, q_bool: np.ndarray, k_dev: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hamming top-k through ``flat_topk_fused`` on the ±1 mirror:
        (dists (B_pad, k_dev) int32, rows (B_pad, k_dev) int64)."""
        b = q_bool.shape[0]
        qp = np.zeros((pow2_at_least(b, 8), self._dev_pm1.shape[1]),
                      dtype=np.float32)
        qp[:b, :self._bits] = q_bool * 2.0 - 1.0
        d, rows = fused_scan.flat_topk_fused(
            self._dev_pm1, self._dev_pm1_sq, self._dev_valid,
            torch.from_numpy(qp).to(self._device), k=k_dev)
        # d = sqrt(4 * hamming) exactly; recover the integer distance.
        ham = torch.round(d * d / 4.0)
        ham = torch.where(rows >= 0, ham, float(INVALID)).int()
        return ham, rows

    # ------------------------------------------------------------------
    # query
    # ------------------------------------------------------------------
    def knn(self, q_bool: np.ndarray, k: int
            ) -> Tuple[np.ndarray, np.ndarray]:
        """
        Hamming top-k for a (B, bits) boolean query batch.

        :return: (dists (B, k') int32 ascending — raw bit counts, not
            normalized — and codes (B, k', bits) bool) with
            k' = min(k, live codes).
        """
        q_bool = np.atleast_2d(np.asarray(q_bool)).astype(bool)
        with self._lock, trace_span("hamming.knn"):
            if self._host is None:
                raise ValueError("Code store is empty.")
            if q_bool.shape[1] != self._bits:
                raise ValueError(f"Query bit length {q_bool.shape[1]} != "
                                 f"index {self._bits}.")
            host = self._host
            b = q_bool.shape[0]
            q_packed = bits_util.pack_bit_vectors_u32(q_bool)
            k_eff = min(k, self._n_live)
            k_dev = min(pow2_at_least(k_eff), self._capacity)
            if self._mesh is not None:
                # Imported here: the sharded scan imports this module.
                from smqtk_indexing_tpu_torch.parallel.sharded_scan import (
                    sharded_hamming_topk,
                )
                qp = np.zeros((pow2_at_least(b, 8), q_packed.shape[1]),
                              dtype=np.uint32)
                qp[:b] = q_packed
                dd, rr = sharded_hamming_topk(
                    self._mesh, self._dev, self._dev_valid,
                    qp.view(np.int32), k=k_dev)
                dists = dd[:b, :k_eff].cpu().numpy()
                rows = rr[:b, :k_eff].cpu().numpy()
            elif host.shape[0] <= HOST_SCAN_MAX:
                # Tiny index: the native (C++) host scan over the host
                # mirror; ties in ascending row order, as the XOR route.
                dists, rows = native.hamming_topk(
                    host, self._valid_host, q_packed, k_eff)
            else:
                if self._mxu_eligible():
                    self._ensure_pm1()
                    dd, rr = self._knn_mxu(q_bool, k_dev)
                else:
                    qp = np.zeros((pow2_at_least(b, 8), q_packed.shape[1]),
                                  dtype=np.uint32)
                    qp[:b] = q_packed
                    dd, rr = hamming_topk(
                        self._dev, self._dev_valid,
                        words_to_tensor(qp, self._device), k=k_dev)
                dists = dd[:b, :k_eff].cpu().numpy()
                rows = rr[:b, :k_eff].cpu().numpy()
        # Unfilled slots carry row -1 (clamp for the host gather; their
        # distances already hold the sentinel).
        sel = host[np.maximum(rows, 0).reshape(-1)]
        codes = bits_util.unpack_bit_vectors_u32(sel, q_bool.shape[1]) \
            .reshape(b, k_eff, q_bool.shape[1])
        return dists, codes

    # ------------------------------------------------------------------
    # persistence (the JAX store's npz payload)
    # ------------------------------------------------------------------
    def to_bytes(self) -> bytes:
        with self._lock:
            bio = io.BytesIO()
            if self._host is None:
                np.savez(bio, empty=np.array(True))
            else:
                keep = np.flatnonzero(self._valid_host)
                np.savez(bio, packed=self._host[keep],
                         bits=np.array(self._bits))
            return bio.getvalue()

    def from_bytes(self, data: bytes) -> None:
        bio = io.BytesIO(data)
        with np.load(bio) as z:
            if "empty" in z:
                self.clear()
                return
            packed = z["packed"]
            bits = int(z["bits"])
        self.build(bits_util.unpack_bit_vectors_u32(packed, bits))
