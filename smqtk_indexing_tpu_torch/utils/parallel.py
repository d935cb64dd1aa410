"""
Ecosystem-compatibility ``parallel_map``: the port's copy of
``smqtk_indexing_tpu/utils/parallel.py``.

The reference impls (and third-party ``smqtk_plugins`` packages written
against them) import ``smqtk_descriptors.utils.parallel.parallel_map`` for
host-side element fan-out — e.g. pulling ``.vector()`` off descriptor
elements (the reference's smqtk_indexing/impls/nn_index/lsh.py:27,507-509,
mrpt.py:260-264, lsh_functor/itq.py:334). This framework's own impls do
NOT need it: they batch whole element sequences into single device calls
(``nn_many`` / ``get_hash_batch``), so per-element host parallelism
disappears from the hot paths. The shim exists so reference-
style call sites keep working when ported onto this package.

Design notes vs the original:

- Threads only. ``use_multiprocessing=True`` is accepted but downgraded
  to threads with a warning: forking a process that has initialized
  CUDA duplicates runtime state the child cannot use, and
  the typical payload here (``lambda d: d.vector()``) is not
  picklable anyway. Python threads are fine for these IO/object-access
  workloads and are GIL-cooperative with numpy.
- Ordered by default. Every reference call site zips results back
  positionally, so ordered-by-input is the only safe default.
"""
from __future__ import annotations

import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, Iterator

__all__ = ["parallel_map"]


def parallel_map(work_func: Callable[..., Any], *sequences: Iterable,
                 cores: int = None, ordered: bool = True,
                 use_multiprocessing: bool = False,
                 **_compat_kwargs: Any) -> Iterator[Any]:
    """
    Map ``work_func`` over parallel input sequences with a thread pool,
    yielding results lazily in input order.

    Drop-in compatible with ``smqtk_descriptors.utils.parallel
    .parallel_map`` call sites: extra keyword arguments the original
    accepted (``buffer_factor``, ``name``, ``heart_beat``, ...) are
    ignored.

    :param work_func: Function applied to one item from each sequence.
    :param sequences: One or more parallel input iterables (zipped).
    :param cores: Worker thread count (default: executor default).
    :param ordered: Yield results in input order (default True — every
        known call site relies on positional alignment).
    :param use_multiprocessing: Accepted for compatibility; downgraded
        to threads (see module notes).
    :return: Lazy iterator of results.

    >>> list(parallel_map(lambda x: x * 2, [1, 2, 3]))
    [2, 4, 6]
    >>> list(parallel_map(lambda a, b: a + b, [1, 2], [10, 20]))
    [11, 22]
    >>> next(parallel_map(len, [[1, 2], [3]]))
    2
    """
    if use_multiprocessing:
        warnings.warn(
            "parallel_map(use_multiprocessing=True) runs threads here: "
            "forking a CUDA-initialized process is unsafe, and batched "
            "device programs already replace process-level parallelism "
            "in this framework.")
    pool = ThreadPoolExecutor(max_workers=cores)

    def _iter() -> Iterator[Any]:
        try:
            if ordered:
                yield from pool.map(work_func, *sequences)
            else:
                from concurrent.futures import as_completed
                futures = [pool.submit(work_func, *args)
                           for args in zip(*sequences)]
                for f in as_completed(futures):
                    yield f.result()
        finally:
            pool.shutdown(wait=False)

    return _iter()
