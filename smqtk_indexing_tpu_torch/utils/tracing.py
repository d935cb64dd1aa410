"""
Tracing and counters for the PyTorch port.

Counterpart of ``smqtk_indexing_tpu/utils/tracing.py:31-85``:

- ``Counters`` / ``COUNTERS``: thread-safe named counters.
- ``trace_span(name)``: a ``torch.profiler.record_function`` range (visible
  in a ``torch.profiler`` trace) plus a host wall-clock DEBUG log line and
  ``span.<name>.calls`` / ``span.<name>.seconds`` counters. The seconds are
  host time: work queued on the card is counted only up to its enqueue
  unless the span ends in a synchronising call.
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
from typing import Dict, Iterator

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


@contextlib.contextmanager
def trace_span(name: str) -> Iterator[None]:
    """Annotate a host-side span for the profiler + debug logs."""
    t0 = time.monotonic()
    with torch.profiler.record_function(name):
        yield
    dt = time.monotonic() - t0
    COUNTERS.add(f"span.{name}.calls")
    COUNTERS.add(f"span.{name}.seconds", dt)
    LOG.debug("span %s: %.6fs", name, dt)


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
