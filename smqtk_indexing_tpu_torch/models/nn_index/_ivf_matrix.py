"""
The IVF configuration matrix of the port, and its one enforcement point.

Counterpart of ``smqtk_indexing_tpu/models/nn_index/_ivf_matrix.py``: the
same cells are accepted, on one device or sharded over ``n_devices``
(checked by ``parallel.mesh.make_mesh``: a power of two, no more than the
devices there are). Every accepted cell is built and queried by
``tests/test_torch_ivf_contract.py``.

storage='rows' (float32 host mirror):

    dtype       metric                      engine
    float32     euclidean                   K6 (ivf_scan.ivf_query_dma)
    bfloat16    euclidean                   K6
    sq8         euclidean, rerank='exact'   K6 over int8 codes
    sq8         euclidean, rerank='score'   K7 (tiled, as the code tier)
    pq/opq<M>   euclidean                   K8 (tiled, as the code tier)
    float/sq8   inner_product / cosine      ivf.ivf_query (list gather)
    pq/opq<M>   inner_product / cosine      ivf.ivf_query_pq (list gather)

    pq_residual=True: pq/opq<M>, euclidean only (through K8).

    n_devices > 1: every dtype and metric above, through the list gathers
    a shard (ivf.ivf_query / ivf_query_pq, residual PQ included): K6 and
    the tiled routing are single-device, as in JAX.

Layouts whose sublists exceed ``L_MAX - 32`` rows, or whose capacity is
under ``L_MAX``, take ``ivf.ivf_query`` too.

storage='code' (int8 / uint8 code host mirror, the capacity tier):

    sq8         euclidean / inner_product / cosine, K7; rerank='exact'
                also runs K3 for the winners' segments. inner_product
                zeroes the row stats; cosine encodes unit rows and
                normalizes queries.
    pq/opq<M>   euclidean / inner_product / cosine, K8 (and K3 for
                rerank='exact').
    pq_residual=True: pq/opq<M>, euclidean or cosine (the euclidean
                residual pipeline over unit-sphere codes).
    n_devices > 1: every cell above, K7 / K8 (and K3) a shard.

rerank='score' changes results only on the tiled paths; elsewhere
distances are exact already, so it is accepted and has no effect.
"""
from __future__ import annotations

from smqtk_indexing_tpu_torch.ops.ivf import METRICS
from smqtk_indexing_tpu_torch.ops.pq import pq_m


def validate_ivf_combination(metric: str, dtype: str, storage: str,
                             rerank: str, n_devices, pq_residual: bool
                             ) -> None:
    """
    Reject an unsupported IVF configuration with its reason.

    :raises ValueError: an unknown metric, dtype, storage or rerank value;
        storage='code' with a float dtype; pq_residual with a non-PQ dtype,
        with inner_product, or with cosine on the rows tier.
    """
    is_pq = pq_m(dtype) is not None
    if metric not in METRICS:
        raise ValueError(
            f"metric must be one of {METRICS}, got {metric!r}")
    if dtype not in ("float32", "bfloat16", "sq8") and not is_pq:
        raise ValueError(
            "dtype must be 'float32' | 'bfloat16' | 'sq8' | 'pq<M>' "
            f"| 'opq<M>', got {dtype!r}")
    if storage not in ("rows", "code"):
        raise ValueError(
            f"storage must be 'rows' | 'code', got {storage!r}")
    if rerank not in ("exact", "score"):
        raise ValueError(
            f"rerank must be 'exact' | 'score', got {rerank!r}")
    if pq_residual:
        if not is_pq:
            raise ValueError(
                "pq_residual requires a PQ dtype ('pq<M>'/'opq<M>'), "
                f"got {dtype!r}")
        if metric == "cosine" and storage != "code":
            raise ValueError(
                "pq_residual with metric='cosine' requires storage='code' "
                "(the code tier's codes carry unit rows, so the L2 "
                "residual pipeline is cosine ranking on the unit sphere; "
                "the rows tier's codes carry raw rows)")
        if metric == "inner_product":
            raise ValueError(
                "pq_residual serves euclidean (any storage) or cosine "
                "(storage='code'); inner_product has no L2 probe-score "
                "decomposition for the per-probe -2<q,c> term")
    if storage == "code" and dtype != "sq8" and not is_pq:
        raise ValueError(
            "storage='code' (code-resident capacity tier) requires "
            f"dtype='sq8', 'pq<M>' or 'opq<M>', got {dtype!r}")
