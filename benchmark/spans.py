"""The program's host spans as the harness reads them: each
``utils.tracing.trace_span`` adds ``span.<name>.calls`` and
``span.<name>.seconds`` to the program's ``COUNTERS``, which the run
snapshots over the window (``Run.counters``)."""
from typing import Optional


def ms_a_call(run, name: str) -> Optional[float]:
    """Host ms a call of span ``name`` over the window, or None where the
    program has no such span."""
    calls = run.counters.get(f"span.{name}.calls", 0.0)
    if not calls:
        return None
    return 1e3 * run.counters[f"span.{name}.seconds"] / calls
