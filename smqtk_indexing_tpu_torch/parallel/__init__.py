"""
Multi-device layer of the port: the counterpart of
``smqtk_indexing_tpu/parallel/``.

The JAX package shards the (N, d) matrix (or packed codes, or tiled
codes) by rows across a ``jax.sharding.Mesh``; each device runs the
single-device program on its shard inside ``shard_map``, and a k-sized
all-gather and merge gives the global result. The port keeps that
single-controller model in one process (``mesh.Mesh``): each shard's
tensors live on its device, each shard runs the port's single-device
function, and the (B, k) results merge on the mesh's first device. There
is no ``torch.distributed``: one call fans out over every shard, as the
SMQTK interfaces are single-caller APIs.
"""
from smqtk_indexing_tpu_torch.parallel.mesh import (  # noqa: F401
    DCN_AXIS, SHARD_AXIS, Mesh, make_mesh, replicate, shard_rows,
)
from smqtk_indexing_tpu_torch.parallel.sharded_ivf import (  # noqa: F401
    shard_csr, sharded_ivf_query, sharded_ivf_query_pq,
)
from smqtk_indexing_tpu_torch.parallel.sharded_ivf_code import (  # noqa: F401
    shard_tiled_layout, sharded_ivf_query_tiled, sharded_ivf_query_tiled_pq,
)
from smqtk_indexing_tpu_torch.parallel.sharded_mrpt import (  # noqa: F401
    shard_leaf_tables, sharded_mrpt_query,
)
from smqtk_indexing_tpu_torch.parallel.sharded_scan import (  # noqa: F401
    sharded_flat_topk, sharded_hamming_topk, sharded_kmeans_step,
    sharded_pq_topk, sharded_rerank_topk, sharded_sq8_topk,
)
