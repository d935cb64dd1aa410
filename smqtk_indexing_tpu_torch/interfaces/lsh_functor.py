"""
Locality-sensitive hash functor interface.

Contract-parity with SMQTK-Indexing smqtk_indexing/interfaces/lsh_functor.py:11-41
(descriptor vector -> boolean hash bit-vector; similar inputs should collide
with high probability).

TPU-first addition: ``get_hash_batch`` maps a whole (n, d) matrix to an
(n, bits) boolean matrix in one device program — the reference's
per-descriptor Python hashing loop
(SMQTK-Indexing smqtk_indexing/impls/nn_index/lsh.py:316-321) becomes a
single batched matmul+sign.
"""
import abc

import numpy as np

from smqtk_indexing_tpu_torch.core.configuration import Configurable
from smqtk_indexing_tpu_torch.core.plugin import Pluggable


class LshFunctor (Configurable, Pluggable):
    """
    Maps descriptor vectors to locality-sensitive hash codes (boolean
    bit-vectors), maximizing collision probability for similar inputs.

    Functors requiring a trained model document their own ``fit`` method.
    """

    def __call__(self, descriptor: np.ndarray) -> np.ndarray:
        return self.get_hash(descriptor)

    @abc.abstractmethod
    def get_hash(self, descriptor: np.ndarray) -> np.ndarray:
        """
        :param descriptor: Descriptor vector to hash.
        :return: Hash code as a 1D boolean numpy array.
        """

    def get_hash_batch(self, descriptors: np.ndarray) -> np.ndarray:
        """
        Batched hashing: (n, d) float matrix -> (n, bits) boolean matrix.

        Default implementation loops ``get_hash``; device-backed functors
        override this with one batched kernel.
        """
        mat = np.atleast_2d(np.asarray(descriptors))
        return np.vstack([self.get_hash(row) for row in mat])

    def hash_model(self):
        """
        Optional jit-fusable affine form of this functor:
        ``hash(x) = ((norm_rows(x, normalize) - mean) @ proj) >= 0``.

        :return: ``(mean (d,) float32, proj (d, bits) float32, normalize)``
            when the functor is expressible this way AND fitted, else
            ``None``. Enables the single-dispatch LSH serving program
            (ops/lsh_fused.py) to inline hashing; functors with other
            shapes simply return None and serve through the two-dispatch
            path.
        """
        return None
