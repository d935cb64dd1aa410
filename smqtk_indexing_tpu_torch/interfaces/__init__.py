"""
The three interfaces: the port's own copy of
``smqtk_indexing_tpu/interfaces/``. The port's implementations subclass
these, so ``get_impls()`` returns the port's classes.
"""
from smqtk_indexing_tpu_torch.interfaces.hash_index import HashIndex  # noqa: F401
from smqtk_indexing_tpu_torch.interfaces.lsh_functor import LshFunctor  # noqa: F401
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (  # noqa: F401
    NearestNeighborsIndex,
)
