"""
The spreads that the end-to-end bounds are set from.

    python3 -m benchmark.spreads SET1.jsonl SET2.jsonl [...]

Each file holds the result lines of one set of runs of one cell (the
same seeds in every set). For each end-to-end metric it prints each
set's spread (``stats.spread``: the quartile gap over the median), the
widest, five times the widest (the bound it suggests, never under 1%),
and each set's median.
"""
from __future__ import annotations

import json
import statistics
import sys
from typing import Dict, List, Sequence

from benchmark.stats import spread


def read_set(path: str) -> Dict[str, List[float]]:
    """Metric name -> values, from the result lines of ``path``."""
    out: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            for name, m in json.loads(line)["metrics"].items():
                out.setdefault(name, []).append(float(m["value"]))
    return out


def report(paths: Sequence[str]) -> Dict[str, dict]:
    sets = [read_set(p) for p in paths]
    names = sorted(set().union(*sets))
    rows = {}
    for name in names:
        got = [s[name] for s in sets if len(s.get(name, ())) >= 2]
        spreads = [spread(v) for v in got]
        widest = max(spreads) if spreads else None
        rows[name] = {
            "spreads": spreads, "widest": widest,
            "bound": None if widest is None else max(0.01, 5 * widest),
            "medians": [statistics.median(v) for v in got]}
    return rows


def main(argv: Sequence[str] = None) -> int:
    for name, row in report(sys.argv[1:] if argv is None else argv).items():
        print(json.dumps({"metric": name, **row}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
