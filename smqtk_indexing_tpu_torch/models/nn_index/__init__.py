"""Nearest-neighbour index implementations of the port: flat and IVF."""
from smqtk_indexing_tpu_torch.models.nn_index.flat import (  # noqa: F401
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.ivf import (  # noqa: F401
    IvfNearestNeighborsIndex,
)
