"""
smqtk_indexing_tpu_torch — the PyTorch / CUDA port of
``smqtk_indexing_tpu``, for NVIDIA Hopper GPUs.

The port imports nothing of ``smqtk_indexing_tpu``. It keeps its own
copies of the JAX package's jax-free layers at the same paths (``core``,
``data``, ``interfaces``, ``utils/iter_validation.py`` and the layout
helpers of ``ops/device.py``), so it has its own interface hierarchy and
plugin registry, with the same configuration format and persisted
payloads. Its compute is PyTorch, and each TPU kernel on a ported path is
a hand-written CUDA kernel under ``csrc/``. It imports ``torch`` and never
``jax``.
"""
from smqtk_indexing_tpu_torch.interfaces.hash_index import HashIndex  # noqa: F401
from smqtk_indexing_tpu_torch.interfaces.lsh_functor import LshFunctor  # noqa: F401
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (  # noqa: F401
    NearestNeighborsIndex,
)

__version__ = "0.1.0"
