"""
Wall-clock interval loop-rate reporter: the port's copy of
``smqtk_indexing_tpu/utils/progress_reporter.py``, contract-compatible with
the reference's ``smqtk_indexing/utils/progress_reporter.py``.
"""
from __future__ import annotations

import threading
import time
from typing import Callable


class ProgressReporter:
    """
    Calls a logging function with loop rate statistics at most once per
    configured interval. ``start()`` -> ``increment_report()`` per loop ->
    final ``report()``.
    """

    def __init__(self, log_func: Callable[..., None],
                 interval: float, what_per_second: str = "Loops"):
        self.log_func = log_func
        self.interval = float(interval)
        self.what_per_second = what_per_second
        self.lock = threading.RLock()
        self.c_last = self.c = 0
        self.t_start = self.t_last = self.t = 0.0
        self.started = False

    def start(self) -> "ProgressReporter":
        with self.lock:
            self.started = True
            self.c_last = self.c = 0
            self.t_start = self.t_last = self.t = time.time()
        return self

    def increment_report(self) -> None:
        with self.lock:
            if not self.started:
                raise RuntimeError("Reporter needs to be started first.")
            self.c += 1
            self.t = time.time()
            if (self.t - self.t_last) >= self.interval:
                self.report()
                self.t_last = self.t
                self.c_last = self.c

    def increment_report_threadsafe(self) -> None:
        with self.lock:
            self.increment_report()

    def report(self) -> None:
        with self.lock:
            if not self.started:
                raise RuntimeError("Reporter needs to be started first.")
            t_elapsed = self.t - self.t_start
            dt = self.t - self.t_last
            local_rate = (self.c - self.c_last) / dt if dt > 0 else 0.0
            global_rate = self.c / t_elapsed if t_elapsed > 0 else 0.0
            self.log_func(
                "%s per second %f (avg %f) (%d current interval / %d total)"
                % (self.what_per_second, local_rate, global_rate,
                   self.c - self.c_last, self.c)
            )

    def report_threadsafe(self) -> None:
        with self.lock:
            self.report()
