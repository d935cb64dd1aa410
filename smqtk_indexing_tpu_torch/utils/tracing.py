"""
Tracing and counters for the PyTorch port.

Counterpart of ``smqtk_indexing_tpu/utils/tracing.py:31-85``:

- ``Counters`` / ``COUNTERS``: thread-safe named counters. Besides the
  span counters below, the indexes count their work here (``flat.queries``,
  ``ivf.queries``, ``ivf.probed_lists``, ``mrpt.candidates_examined``,
  ``lsh.candidates``, ``host_stream.bytes`` and the like): the reference's
  debug-log payloads, read through ``COUNTERS.snapshot()``.
- ``trace_span(name)``: a host span. It always reads the host clock and
  adds ``span.<name>.calls`` / ``span.<name>.seconds`` to ``COUNTERS`` (one
  lock acquisition) and logs a DEBUG line. Only while a ``torch.profiler``
  profile runs on the calling thread does it also open a
  ``torch.profiler.record_function`` range of the same name, so with the
  profiler off a span costs a clock read and a counter add, not a range.
  The seconds are host time: work queued on the card is counted only up to
  its enqueue unless the span ends in a synchronising call.
- ``device_range(name)``: the profiler range alone, under the same gate,
  with no clock read and no counter, for work whose host time is only its
  enqueue. The device time under it is read from a trace.
- ``trace(log_dir)``: a ``torch.profiler.profile`` of the enclosed block
  (CPU, and CUDA when a card is present), exported as a Chrome trace.
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import ContextManager, Dict, Iterator, Optional

import torch

LOG = logging.getLogger(__name__)


class Counters:
    """Thread-safe named counters with snapshot/reset semantics."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, float] = defaultdict(float)

    def add(self, name: str, value: float = 1.0) -> None:
        with self._lock:
            self._counts[name] += value

    def add_span(self, name: str, seconds: float) -> None:
        """One call of span ``name``: 1 to ``span.<name>.calls`` and
        ``seconds`` to ``span.<name>.seconds``, under one lock
        acquisition."""
        calls, secs = f"span.{name}.calls", f"span.{name}.seconds"
        with self._lock:
            self._counts[calls] += 1.0
            self._counts[secs] += seconds

    def get(self, name: str) -> float:
        with self._lock:
            return self._counts.get(name, 0.0)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return dict(self._counts)

    def reset(self) -> None:
        with self._lock:
            self._counts.clear()


#: Process-global counter registry used by the index implementations.
COUNTERS = Counters()

_NO_RANGE = contextlib.nullcontext()


def _range(name: str) -> ContextManager:
    """A profiler range while a profiler runs on this thread, else a
    shared no-op context. A range opened on a thread the profiler does not
    trace would not reach its trace."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_RANGE


class _Span(contextlib.ContextDecorator):
    """One entry of :func:`trace_span`; a decorator enters a fresh one a
    call, so concurrent calls do not share its clock."""

    def __init__(self, name: str) -> None:
        self.name = name
        self._range: Optional[ContextManager] = None
        self._t0 = 0.0

    def _recreate_cm(self) -> "_Span":
        return _Span(self.name)

    def __enter__(self) -> None:
        self._range = _range(self.name)
        self._range.__enter__()
        self._t0 = time.monotonic()

    def __exit__(self, *exc) -> bool:
        dt = time.monotonic() - self._t0
        self._range.__exit__(*exc)
        if exc[0] is None:
            COUNTERS.add_span(self.name, dt)
            LOG.debug("span %s: %.6fs", self.name, dt)
        return False


def trace_span(name: str) -> _Span:
    """A host span (context manager or decorator): ``span.<name>.calls``
    and ``span.<name>.seconds`` in ``COUNTERS`` and a DEBUG line on every
    call that returns; a profiler range of the same name only while a
    profiler runs on this thread."""
    return _Span(name)


def device_range(name: str) -> ContextManager:
    """A profiler range of ``name`` while a profiler runs on this thread,
    else nothing. It keeps no counter: the host seconds of work the card
    runs asynchronously are its enqueue time and say nothing of the card;
    the device time launched under the range is read from the trace."""
    return _range(name)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the enclosed block; writes ``<log_dir>/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
