"""
Hash-code index interface.

Contract-parity with SMQTK-Indexing smqtk_indexing/interfaces/hash_index.py:10-182:
indexes *unique* boolean hash bit-vectors; ``nn`` returns normalized Hamming
distances in [0, 1] (fraction of differing bits relative to the query's bit
length) and never returns a duplicate code for one query.
"""
import abc
from typing import Iterable, Sequence, Tuple

import numpy as np

from smqtk_indexing_tpu_torch.core.configuration import Configurable
from smqtk_indexing_tpu_torch.core.plugin import Pluggable
from smqtk_indexing_tpu_torch.utils.iter_validation import check_empty_iterable


class HashIndex (Configurable, Pluggable):
    """
    Index over unique hash-code bit-vectors under normalized Hamming
    distance. Not substitutable for ``NearestNeighborsIndex`` (different
    element and distance domain).
    """

    def __len__(self) -> int:
        return self.count()

    @staticmethod
    def _empty_iterable_exception() -> BaseException:
        """Exception raised for empty build/update/remove input iterables."""
        return ValueError("No hash vectors in provided iterable.")

    def build_index(self, hashes: Iterable[np.ndarray]) -> None:
        """
        (Re)build the index over the given boolean hash vectors, replacing
        any existing index state. Duplicate codes are collapsed.

        :raises ValueError: The given iterable yielded no elements.
        """
        check_empty_iterable(hashes, self._build_index,
                             self._empty_iterable_exception())

    def update_index(self, hashes: Iterable[np.ndarray]) -> None:
        """
        Additively update the index with the given boolean hash vectors,
        creating a new index if none exists yet.

        :raises ValueError: The given iterable yielded no elements.
        """
        check_empty_iterable(hashes, self._update_index,
                             self._empty_iterable_exception())

    def remove_from_index(self, hashes: Iterable[np.ndarray]) -> None:
        """
        Remove the given hash codes from the index.

        :raises ValueError: The given iterable yielded no elements.
        :raises KeyError: One or more codes are not in the index; the index
            is not modified in that case.
        """
        check_empty_iterable(hashes, self._remove_from_index,
                             self._empty_iterable_exception())

    def nn(self, h: np.ndarray, n: int = 1
           ) -> Tuple[np.ndarray, Sequence[float]]:
        """
        Return up to ``n`` nearest hash codes to ``h`` and their normalized
        Hamming distances in [0, 1], ascending.

        :raises ValueError: The index is empty.
        """
        if not self.count():
            raise ValueError("No index currently set to query from!")
        return self._nn(h, n)

    def nn_many(self, hs: np.ndarray, n: int = 1
                ) -> "list[Tuple[np.ndarray, Tuple[float, ...]]]":
        """
        Batched near-code query: one (codes, distances) result per row of
        the (B, bits) boolean query matrix. Device-backed implementations
        execute this as a single program launch; semantics per row match
        ``nn``.

        :raises ValueError: The index is empty.
        """
        if not self.count():
            raise ValueError("No index currently set to query from!")
        return self._nn_many(np.atleast_2d(np.asarray(hs)), n)

    def _nn_many(self, hs: np.ndarray, n: int = 1
                 ) -> "list[Tuple[np.ndarray, Tuple[float, ...]]]":
        """Default batched query: loop the scalar hook."""
        return [self._nn(h, n) for h in hs]

    @abc.abstractmethod
    def count(self) -> int:
        """:return: Number of unique hash codes currently indexed."""

    @abc.abstractmethod
    def _build_index(self, hashes: Iterable[np.ndarray]) -> None:
        """Implementation hook for ``build_index`` (input known non-empty)."""

    @abc.abstractmethod
    def _update_index(self, hashes: Iterable[np.ndarray]) -> None:
        """Implementation hook for ``update_index`` (input known non-empty)."""

    @abc.abstractmethod
    def _remove_from_index(self, hashes: Iterable[np.ndarray]) -> None:
        """Implementation hook for ``remove_from_index``."""

    @abc.abstractmethod
    def _nn(self, h: np.ndarray, n: int = 1
            ) -> Tuple[np.ndarray, Tuple[float, ...]]:
        """Implementation hook for ``nn`` (index known non-empty)."""
