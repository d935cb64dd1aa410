"""Order statistics the benchmark reports and bounds."""
from __future__ import annotations

import math
import statistics
from typing import Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank ``q``-th percentile: the smallest value with at least
    ``q`` percent of ``values`` at or below it.

    :raises ValueError: ``values`` is empty or ``q`` is outside (0, 100].
    """
    if not values:
        raise ValueError("percentile of no values")
    if not 0 < q <= 100:
        raise ValueError(f"percentile {q} is outside (0, 100]")
    ordered = sorted(values)
    return ordered[max(1, math.ceil(q / 100.0 * len(ordered))) - 1]


def spread(values: Sequence[float]) -> float:
    """The distance between the first and the third quartile, as
    ``statistics.quantiles(values, n=4)`` gives them, as a share of the
    median."""
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)
