"""
Host-side (numpy) distance functions: the port's copy of
``smqtk_indexing_tpu/utils/metrics.py`` (numpy only), semantics-compatible
with the reference's ``smqtk_indexing/utils/metrics.py``. Device-side
batched equivalents live in ``smqtk_indexing_tpu_torch.ops.metrics``.
"""
from math import pi
from typing import Union

import numpy as np


def histogram_intersection_distance(
        a: np.ndarray, b: np.ndarray) -> Union[float, np.ndarray]:
    """
    Histogram intersection distance in [0, 1] between histogram vectors or
    matrices (branchless formulation). 0 = full intersection.

    1D+1D -> scalar; any 2D involvement -> vector of row distances.

    >>> import numpy as np
    >>> float(histogram_intersection_distance(
    ...     np.array([0.5, 0.5]), np.array([0.5, 0.5])))
    0.0
    >>> float(histogram_intersection_distance(
    ...     np.array([1.0, 0.0]), np.array([0.0, 1.0])))
    1.0
    """
    sum_axis = 1
    if a.ndim == 1 and b.ndim == 1:
        sum_axis = 0
    return 1.0 - ((np.add(a, b) - np.abs(np.subtract(a, b))).sum(sum_axis) * 0.5)


def histogram_intersection_distance_fast(i: np.ndarray, j: np.ndarray) -> float:
    """1D-only histogram intersection distance."""
    return 1.0 - float((i + j - np.abs(i - j)).sum() * 0.5)


def euclidean_distance(i: np.ndarray, j: np.ndarray) -> Union[float, np.ndarray]:
    """Euclidean distance between vectors (or row-wise for matrices)."""
    sum_axis = 1
    if i.ndim == 1 and j.ndim == 1:
        sum_axis = 0
    return np.sqrt(np.square(i - j).sum(sum_axis))


def cosine_similarity(i: np.ndarray, j: np.ndarray) -> Union[float, np.ndarray]:
    """
    Cosine similarity between 1D vector ``i`` and vector/matrix ``j``:
    1 = identical direction, 0 = orthogonal, -1 = opposite.
    """
    assert i.ndim == 1
    j2 = j.reshape(1, -1) if j.ndim == 1 else j
    denom = np.linalg.norm(i) * np.linalg.norm(j2, axis=1)
    # Avoid div-by-zero: zero-norm pairs get similarity 0.
    denom = np.where(denom == 0, 1.0, denom)
    sim = (j2 @ i) / denom
    if sim.size == 1:
        return float(sim[0])
    return sim


def cosine_distance(i: np.ndarray, j: np.ndarray,
                    pos_vectors: bool = True) -> Union[float, np.ndarray]:
    """
    Angular distance in [0, 1] derived from cosine similarity:
    ``(1 + pos_vectors) * arccos(sim) / pi``.
    """
    sim = np.clip(cosine_similarity(i, j), -1.0, 1.0)
    return (1 + bool(pos_vectors)) * np.arccos(sim) / pi


def hamming_distance(i: int, j: int) -> int:
    """
    Hamming distance between two arbitrary-precision integers (number of
    differing bit positions; no bit-width cap).

    >>> hamming_distance(0b1010, 0b1001)
    2
    >>> hamming_distance(1 << 200, 0)
    1
    """
    return (i ^ j).bit_count()
