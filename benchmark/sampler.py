"""A uniform sample of fixed size over a stream of unknown length
(reservoir sampling, Li's Algorithm L): its cost a batch is the number of
items it takes, not the batch's length, so it can sit in the measured
window."""
from __future__ import annotations

import math
import random
from typing import Any, Callable, List


class Reservoir:
    """``size`` items drawn uniformly from all items offered, by ``seed``.

    Offer a batch of ``n`` items with :meth:`offer`; ``make(j)`` builds
    the ``j``-th item of the batch only when it is taken.
    """

    def __init__(self, size: int, seed: int):
        if size < 1:
            raise ValueError("a reservoir holds at least one item")
        self.size = size
        self.items: List[Any] = []
        self.seen = 0
        self._rng = random.Random(seed)
        self._w = 1.0
        self._next = size - 1
        self._skip()

    def _log_u(self) -> float:
        return math.log(1.0 - self._rng.random())       # u in (0, 1]

    def _skip(self) -> None:
        """Draw the stream index of the next item that replaces one."""
        self._w *= math.exp(self._log_u() / self.size)
        self._next += math.floor(self._log_u() / math.log1p(-self._w)) + 1

    def offer(self, n: int, make: Callable[[int], Any]) -> None:
        lo, hi = self.seen, self.seen + n
        for j in range(lo, min(hi, self.size)):
            self.items.append(make(j - lo))
        while self._next < hi:
            self.items[self._rng.randrange(self.size)] = make(
                self._next - lo)
            self._skip()
        self.seen = hi
