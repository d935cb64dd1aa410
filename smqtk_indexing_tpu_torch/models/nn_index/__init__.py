"""Nearest-neighbour index implementations of the port (convenience
re-exports, the JAX package's set)."""
from smqtk_indexing_tpu_torch.models.nn_index.autotune import (  # noqa: F401
    AutotunedNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.factory import (  # noqa: F401
    index_from_factory_string,
)
from smqtk_indexing_tpu_torch.models.nn_index.flat import (  # noqa: F401
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.ivf import (  # noqa: F401
    IvfNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.lsh import (  # noqa: F401
    LSHNearestNeighborIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (  # noqa: F401
    MRPTNearestNeighborsIndex,
)
