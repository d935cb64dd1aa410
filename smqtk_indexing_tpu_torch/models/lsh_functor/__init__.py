"""LSH functor implementations of the port (convenience re-exports)."""
from smqtk_indexing_tpu_torch.models.lsh_functor.itq import (  # noqa: F401
    ItqFunctor,
)
from smqtk_indexing_tpu_torch.models.lsh_functor.simple_rp import (  # noqa: F401
    SimpleRPFunctor,
)
