"""Hash-index implementations of the port (convenience re-exports)."""
from smqtk_indexing_tpu_torch.models.hash_index.block import (  # noqa: F401
    BallTreeHashIndex,
)
from smqtk_indexing_tpu_torch.models.hash_index.linear import (  # noqa: F401
    LinearHashIndex,
)
