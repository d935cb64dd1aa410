"""Nearest-neighbour index implementations of the port (flat so far)."""
from smqtk_indexing_tpu_torch.models.nn_index.flat import (  # noqa: F401
    FlatNearestNeighborsIndex,
)
