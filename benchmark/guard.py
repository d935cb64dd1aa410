"""The check that a run loaded no JAX: top-level module names compared
whole, since the port's package name begins with the JAX package's."""
from __future__ import annotations

import sys
from typing import Iterable, List

#: Top-level names that no process of the benchmark may hold.
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "smqtk_indexing_tpu"})


def forbidden_modules(names: Iterable[str] = None) -> List[str]:
    """The loaded modules (by default ``sys.modules``) whose top-level
    name, the part before the first dot, is one of :data:`FORBIDDEN`."""
    names = sys.modules if names is None else names
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
