"""
Simple random-projection LSH functor: the port of
``smqtk_indexing_tpu/models/lsh_functor/simple_rp.py``.

Capability-parity with the reference's ``SimpleRPFunctor``
(SMQTK-Indexing smqtk_indexing/impls/lsh_functor/simple_rp.py:15-127): fit
records the sample mean and a (dim, bits) Gaussian projection; hashing is
``(v - mean) @ rps >= 0``. Explicitly a baseline functor, "not for
production" (simple_rp.py:17-20) — use ItqFunctor.

The projection is drawn with numpy's ``default_rng(random_seed)``, as the
JAX functor draws it (``simple_rp.py:86``), so one seed gives both packages
the same model; ``get_hash_batch`` hashes the whole matrix with one
full-f32 product on ``device`` (``ops/itq.hash_batch``).
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, Optional, Union

import numpy as np
import torch

from smqtk_indexing_tpu_torch.data.descriptor import DescriptorElement
from smqtk_indexing_tpu_torch.interfaces.lsh_functor import LshFunctor
from smqtk_indexing_tpu_torch.ops.device import resolve_device
from smqtk_indexing_tpu_torch.ops.itq import hash_batch


def norm_rows(mat: np.ndarray,
              normalize: Optional[Union[int, float, str]]) -> np.ndarray:
    """
    Row-normalize a matrix with numpy ``ord`` semantics, or pass through when
    ``normalize`` is None (reference normalization contract, SMQTK-Indexing
    smqtk_indexing/impls/lsh_functor/itq.py:172-191). Zero-norm rows are
    left unchanged.
    """
    if normalize is None:
        return mat
    norms = np.linalg.norm(mat, ord=normalize, axis=-1, keepdims=True)
    return mat / np.where(norms == 0, 1.0, norms)


class SimpleRPFunctor (LshFunctor):
    """
    Baseline random-projection hashing.

    :param bit_length: Hash code length in bits.
    :param normalize: Optional numpy ``ord`` to row-normalize descriptors
        with before projection.
    :param random_seed: Seed for the Gaussian projection matrix.
    :param device: torch device of the model: 'cuda' (default; raises when
        no card is present) or 'cpu'.
    """

    def __init__(self,
                 bit_length: int = 8,
                 normalize: Optional[Union[int, float, str]] = None,
                 random_seed: Optional[int] = None,
                 device: str = "cuda"):
        super().__init__()
        self.bit_length = int(bit_length)
        self.normalize = normalize
        self.random_seed = random_seed
        self.device = str(resolve_device(device))
        # Model components
        self.rps: Optional[torch.Tensor] = None       # (d, bits)
        self.mean_vec: Optional[torch.Tensor] = None  # (d,)

    def get_config(self) -> Dict[str, Any]:
        return {
            "bit_length": self.bit_length,
            "normalize": self.normalize,
            "random_seed": self.random_seed,
            "device": self.device,
        }

    def has_model(self) -> bool:
        return self.rps is not None and self.mean_vec is not None

    def fit(self, descriptors: Iterable[DescriptorElement]) -> np.ndarray:
        """
        Fit the projection model to a descriptor sample.

        :return: The fitted mean vector.
        """
        vecs = [d.vector() for d in descriptors]
        if not vecs:
            raise ValueError("No descriptors given to fit on.")
        x = norm_rows(np.vstack(vecs).astype(np.float64), self.normalize)
        rng = np.random.default_rng(self.random_seed)
        d = x.shape[1]
        mean = np.mean(x, axis=0).astype(np.float32)
        rps = rng.standard_normal((d, self.bit_length)).astype(np.float32)
        self.mean_vec = torch.from_numpy(mean).to(self.device)
        self.rps = torch.from_numpy(rps).to(self.device)
        return mean

    def _require_model(self) -> None:
        if not self.has_model():
            raise RuntimeError(
                "Functor has no random projection model; call fit() first.")

    def get_hash(self, descriptor: np.ndarray) -> np.ndarray:
        self._require_model()
        return self.get_hash_batch(
            np.asarray(descriptor).reshape(1, -1))[0]

    def get_hash_batch(self, descriptors: np.ndarray) -> np.ndarray:
        self._require_model()
        mat = np.atleast_2d(np.asarray(descriptors, dtype=np.float32))
        mat = norm_rows(mat, self.normalize)
        return hash_batch(torch.from_numpy(np.ascontiguousarray(mat))
                          .to(self.device), self.mean_vec,
                          self.rps).cpu().numpy()

    def hash_model(self):
        """(mean, rps, normalize) — the affine sign-hash form for the
        fused LSH serving function."""
        if not self.has_model():
            return None
        return (self.mean_vec.cpu().numpy(), self.rps.cpu().numpy(),
                self.normalize)
