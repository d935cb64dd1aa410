"""
Bit-vector <-> integer conversion and packed-word encoding.

The port's copy of ``smqtk_indexing_tpu/utils/bits.py`` (numpy only), so
that both packages pack codes bit for bit alike.

Semantics match SMQTK-Indexing smqtk_indexing/utils/bits.py:4-56: big-endian
bit order (bit 0 of the vector is the most-significant bit of the integer),
arbitrary-precision integers (>64-bit codes).

TPU-first inversion: the reference's O(bits) Python shift loops are replaced
by ``numpy.packbits``-based vectorized conversions, and batch helpers produce
``(n, words)`` uint32 packed code matrices — the device-side storage format
for all Hamming-distance kernels (XOR + population_count instead of
``bin(i ^ j).count('1')``).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np


def bit_vector_to_int_large(v: np.ndarray) -> int:
    """
    Transform a bit vector (values interpreted as [0 | >0]) into its
    arbitrary-precision integer representation, big-endian.

    :param v: 1D vector of bits.
    :return: Integer equivalent.

    >>> bit_vector_to_int_large([1, 0, 1])
    5
    >>> bit_vector_to_int_large([0, 0, 0, 1])
    1
    """
    v = np.asarray(v)
    bits = len(v)
    if bits == 0:
        return 0
    packed = np.packbits(v.astype(bool))
    pad = (-bits) % 8
    return int.from_bytes(packed.tobytes(), "big") >> pad


def int_to_bit_vector_large(integer: int, bits: int = 0) -> np.ndarray:
    """
    Transform an arbitrary-precision integer into a big-endian boolean bit
    vector, optionally of fixed width ``bits``.

    :raises ValueError: ``bits`` is smaller than required to represent
        ``integer``.

    >>> int_to_bit_vector_large(5).astype(int).tolist()
    [1, 0, 1]
    >>> int_to_bit_vector_large(1, bits=4).astype(int).tolist()
    [0, 0, 0, 1]
    """
    size = max(int(integer).bit_length(), 1)
    if bits and (bits - size) < 0:
        raise ValueError(
            "%d bits too small to represent integer value %d."
            % (bits, integer)
        )
    width = bits or size
    nbytes = (width + 7) // 8
    raw = np.frombuffer(int(integer).to_bytes(nbytes, "big"), dtype=np.uint8)
    v = np.unpackbits(raw)
    return v[-width:].astype(bool)


# ---------------------------------------------------------------------------
# Packed-word (device format) helpers
# ---------------------------------------------------------------------------

def bit_matrix_to_ints(mat: np.ndarray) -> List[int]:
    """
    Batch form of :func:`bit_vector_to_int_large`: one vectorized
    ``packbits`` over the whole (n, bits) matrix, then a cheap
    ``int.from_bytes`` per row — the per-element conversion loop is the
    reference's LSH-build hot spot (lsh.py:316-321).
    """
    mat = np.atleast_2d(np.asarray(mat)).astype(bool)
    n, bits = mat.shape
    if bits == 0:
        return [0] * n
    packed = np.packbits(mat, axis=1)
    pad = (-bits) % 8
    buf = packed.tobytes()
    width = packed.shape[1]
    return [int.from_bytes(buf[i * width:(i + 1) * width], "big") >> pad
            for i in range(n)]


def pack_bit_vectors_u32(vectors: np.ndarray) -> np.ndarray:
    """
    Pack a (n, bits) boolean matrix into (n, ceil(bits/32)) uint32 words.

    Word bit order is an internal convention (bit ``i`` lands in word
    ``i // 32``); Hamming distance is invariant to intra-word order, and the
    big-endian public semantics are preserved at the int/bool boundaries
    above.

    >>> import numpy as np
    >>> codes = np.array([[1, 0, 1], [0, 1, 1]], dtype=bool)
    >>> packed = pack_bit_vectors_u32(codes)
    >>> packed.shape
    (2, 1)
    >>> bool(np.array_equal(unpack_bit_vectors_u32(packed, 3), codes))
    True
    """
    v = np.atleast_2d(np.asarray(vectors)).astype(bool)
    n, bits = v.shape
    pad_bits = (-bits) % 32
    if pad_bits:
        v = np.concatenate(
            [v, np.zeros((n, pad_bits), dtype=bool)], axis=1)
    bytes_ = np.packbits(v, axis=1)  # (n, bits_padded/8) uint8, big-endian
    # View groups of 4 bytes as native uint32 words. Intra-word byte order is
    # an internal detail; unpack_bit_vectors_u32 inverts it exactly.
    return np.ascontiguousarray(bytes_).view(np.uint32).reshape(n, -1)


def unpack_bit_vectors_u32(packed: np.ndarray, bits: int) -> np.ndarray:
    """Inverse of :func:`pack_bit_vectors_u32` -> (n, bits) bool matrix."""
    p = np.atleast_2d(np.asarray(packed, dtype=np.uint32))
    n = p.shape[0]
    bytes_ = p.view(np.uint8).reshape(n, -1)
    v = np.unpackbits(bytes_, axis=1)
    return v[:, :bits].astype(bool)


def ints_to_packed_u32(ints: Sequence[int], bits: int) -> np.ndarray:
    """Convert arbitrary-precision integers (big-endian, ``bits`` wide) to a
    (n, words) uint32 packed matrix consistent with
    :func:`pack_bit_vectors_u32`."""
    if len(ints) == 0:
        return np.zeros((0, (bits + 31) // 32), dtype=np.uint32)
    rows = [int_to_bit_vector_large(i, bits) for i in ints]
    return pack_bit_vectors_u32(np.vstack(rows))


def packed_u32_to_ints(packed: np.ndarray, bits: int) -> List[int]:
    """Inverse of :func:`ints_to_packed_u32`."""
    bools = unpack_bit_vectors_u32(packed, bits)
    return [bit_vector_to_int_large(r) for r in bools]
