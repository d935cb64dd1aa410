"""
Empty-iterable guard backing every public build/update/remove template method
(contract of SMQTK-Indexing smqtk_indexing/utils/iter_validation.py:8-28:
peek the first element, raise the given exception when empty, otherwise
re-chain the peeked element and invoke the callback with the intact iterable).
"""
import itertools
from typing import Any, Callable, Iterable


def check_empty_iterable(
    iterable: Iterable,
    callback: Callable[[Iterable], Any],
    exception_inst: BaseException,
) -> None:
    """
    Check that the given iterable yields at least one element; raise
    ``exception_inst`` when it does not, otherwise call ``callback`` with an
    iterable equivalent to the original (the peeked element re-chained).
    """
    it = iter(iterable)
    try:
        first = next(it)
    except StopIteration:
        raise exception_inst
    callback(itertools.chain([first], it))
