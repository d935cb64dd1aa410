"""
Closed loop, one client: the next ``nn_many`` call starts when the last
one has returned, with the batches of the query pool in turn.
"""
from __future__ import annotations

import time
from typing import Callable, List, Sequence, Tuple

#: (start, end, queries) of one call, host perf_counter seconds.
Call = Tuple[float, float, int]


def run(call: Callable[[Sequence], list], batches: Sequence[Sequence],
        seconds: float, on_result: Callable[[int, Sequence, list], None],
        first: int = 0) -> Tuple[float, List[Call], int]:
    """
    Call ``call(batch)`` back to back for ``seconds``.

    A call that ends inside the window counts, and ``on_result(i, batch,
    out)`` sees its answers; the call in flight when the window closes is
    finished and not counted.

    :param first: the index into ``batches`` of the first call.
    :return: (window start, the counted calls, the next batch index).
    """
    i = first
    calls: List[Call] = []
    start = time.perf_counter()
    end = start + seconds
    while True:
        batch = batches[i % len(batches)]
        t0 = time.perf_counter()
        out = call(batch)
        t1 = time.perf_counter()
        i += 1
        if t1 > end:
            return start, calls, i
        calls.append((t0, t1, len(batch)))
        on_result(i - 1, batch, out)
