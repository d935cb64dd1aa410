"""Nearest-neighbour index implementations of the port: flat, IVF and
LSH."""
from smqtk_indexing_tpu_torch.models.nn_index.flat import (  # noqa: F401
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.ivf import (  # noqa: F401
    IvfNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.lsh import (  # noqa: F401
    LSHNearestNeighborIndex,
)
