"""
smqtk_indexing_tpu_torch — the PyTorch / CUDA port of
``smqtk_indexing_tpu``, for NVIDIA Hopper GPUs.

The port shares the JAX package's jax-free layers by import (``core``,
``data``, ``interfaces`` and the pure layout helpers of ``ops/device.py``),
so both packages have one interface hierarchy, one plugin registry and
one configuration format. Its compute is PyTorch, and each TPU kernel on
a ported path is a hand-written CUDA kernel under ``csrc/``. It imports
``torch`` and never ``jax``.
"""
from smqtk_indexing_tpu.interfaces.hash_index import HashIndex  # noqa: F401
from smqtk_indexing_tpu.interfaces.lsh_functor import LshFunctor  # noqa: F401
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (  # noqa: F401
    NearestNeighborsIndex,
)

__version__ = "0.1.0"
