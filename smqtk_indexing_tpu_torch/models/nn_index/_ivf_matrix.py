"""
The IVF configuration matrix of the port, and its one enforcement point.

Counterpart of ``smqtk_indexing_tpu/models/nn_index/_ivf_matrix.py``: the
same cells are accepted, minus the ones whose slices are not ported yet,
which raise ``ValueError`` naming that slice. Every accepted cell is built
and queried by ``tests/test_torch_ivf.py``.

storage='rows' (float32 host mirror):

    dtype     metric                           engine
    float32   euclidean                        K6 (ivf_scan.ivf_query_dma)
    bfloat16  euclidean                        K6
    sq8       euclidean, rerank='exact'        K6 over int8 codes
    sq8       euclidean, rerank='score'        K7 (tiled, as the code tier)
    any       inner_product / cosine           ivf.ivf_query (list gather)

Layouts whose sublists exceed ``L_MAX - 32`` rows, or whose capacity is
under ``L_MAX``, take ``ivf.ivf_query`` too.

storage='code' (int8 code host mirror, the capacity tier):

    sq8       euclidean / inner_product / cosine, K7; rerank='exact' also
              runs K3 for the winners' segments. inner_product zeroes the
              row stats; cosine encodes unit rows and normalizes queries.

rerank='score' changes results only on the tiled paths; elsewhere
distances are exact already, so it is accepted and has no effect.
"""
from __future__ import annotations

import re

from smqtk_indexing_tpu_torch.ops.ivf import METRICS


def _is_pq_dtype(dtype: str) -> bool:
    return bool(re.fullmatch(r"o?pq\d+", dtype))


def validate_ivf_combination(metric: str, dtype: str, storage: str,
                             rerank: str, n_devices, pq_residual: bool
                             ) -> None:
    """
    Reject an unsupported IVF configuration with its reason.

    :raises ValueError: an unknown metric, dtype, storage or rerank value;
        storage='code' with a float dtype; a PQ/OPQ dtype or pq_residual
        (the codec slice); n_devices > 1 (the multi-device slice).
    """
    if metric not in METRICS:
        raise ValueError(
            f"metric must be one of {METRICS}, got {metric!r}")
    if dtype not in ("float32", "bfloat16", "sq8") \
            and not _is_pq_dtype(dtype):
        raise ValueError(
            "dtype must be 'float32' | 'bfloat16' | 'sq8' | 'pq<M>' "
            f"| 'opq<M>', got {dtype!r}")
    if storage not in ("rows", "code"):
        raise ValueError(
            f"storage must be 'rows' | 'code', got {storage!r}")
    if rerank not in ("exact", "score"):
        raise ValueError(
            f"rerank must be 'exact' | 'score', got {rerank!r}")
    if _is_pq_dtype(dtype) or pq_residual:
        raise ValueError(
            f"dtype={dtype!r} / pq_residual={pq_residual} is not ported "
            "yet: PQ, OPQ and residual PQ are the 'Codecs' slice of "
            "ROADMAP.md (queue 1, item 4).")
    if storage == "code" and dtype != "sq8":
        raise ValueError(
            "storage='code' (code-resident capacity tier) requires "
            f"dtype='sq8', got {dtype!r}")
    if n_devices is not None and n_devices > 1:
        raise ValueError(
            f"n_devices={n_devices} is not ported yet: sharding is the "
            "'Multi-device' slice of ROADMAP.md (queue 1, item 9).")
