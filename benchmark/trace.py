"""
The traced stretch: a ``torch.profiler`` trace of a bounded run of calls
after the measured window, read back into device time by host range, the
device's busy share, and where it sat idle.

Device operations (kernels, copies, fills) are tied to the host range
that launched them through the profiler's correlation ids: a launch's
host time stamp lies inside the ``record_function`` ranges that were open
on its thread. The program's ``utils.tracing.trace_span`` opens such a
range for each of its spans, and the harness adds ``benchmark.stretch``
around the stretch and ``benchmark.call`` around each call.
"""
from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

STRETCH = "benchmark.stretch"
CALL = "benchmark.call"
#: Trace categories of device operations.
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
#: Trace categories of the host calls that launch them.
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: The label of host time outside every range.
OUTSIDE = "outside any range"


@dataclass
class Timeline:
    """What a traced stretch read."""
    calls: int
    window_s: float
    busy_s: float
    #: Device seconds of the operations launched inside each host range,
    #: by range name (a range counts the operations of the ranges nested
    #: in it).
    device_s: Dict[str, float] = field(default_factory=dict)
    #: Device seconds by operation name.
    ops_s: Dict[str, float] = field(default_factory=dict)
    #: Idle device seconds by the innermost host range open meanwhile.
    idle_s: Dict[str, float] = field(default_factory=dict)
    #: The longest idle gaps: (seconds, host range, host operation).
    longest_gaps: List[Tuple[float, str, str]] = field(default_factory=list)
    #: Device operations no launch was found for.
    unattributed: int = 0


class _Ranges:
    """Closed host ranges of one name on one thread, for point queries."""

    def __init__(self, spans: List[Tuple[float, float]]):
        spans.sort()
        self.starts = [s for s, _ in spans]
        self.spans = spans

    def covering(self, t: float) -> Optional[Tuple[float, float]]:
        """The range open at ``t``. Ranges of one name on one thread do
        not overlap (the program's spans of a name never nest), so only
        the latest to start at or before ``t`` can hold it."""
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.spans[i][1] >= t:
            return self.spans[i]
        return None


def _merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def read(events: List[dict], calls: int, n_gaps: int = 10) -> Timeline:
    """Reduce a Chrome trace's ``traceEvents`` (time stamps in
    microseconds) to a :class:`Timeline` of the ``benchmark.stretch``
    range.

    :raises ValueError: the trace holds no ``benchmark.stretch`` range.
    """
    ranges: Dict[Tuple[str, object], List[Tuple[float, float]]] = \
        defaultdict(list)
    ops: Dict[object, List[Tuple[float, float, str]]] = defaultdict(list)
    launch: Dict[object, Tuple[float, object]] = {}
    device: List[Tuple[float, float, str, object]] = []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat")
        ts, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        if cat == "user_annotation":
            ranges[ev["name"], ev.get("tid")].append((ts, ts + dur))
        elif cat == "cpu_op":
            ops[ev.get("tid")].append((ts, ts + dur, ev["name"]))
        elif cat in LAUNCH_CATS:
            corr = (ev.get("args") or {}).get("correlation")
            if corr is not None:
                launch[corr] = (ts, ev.get("tid"))
        elif cat in DEVICE_CATS:
            device.append((ts, ts + dur, ev["name"],
                           (ev.get("args") or {}).get("correlation")))
    stretch = [(s, e, tid) for (name, tid), spans in ranges.items()
               if name == STRETCH for s, e in spans]
    if not stretch:
        raise ValueError(f"the trace has no {STRETCH!r} range")
    w0, w1, host_tid = max(stretch, key=lambda x: x[1] - x[0])
    by_name = {name: _Ranges(spans) for (name, tid), spans in ranges.items()
               if tid == host_tid}

    tl = Timeline(calls=calls, window_s=(w1 - w0) * 1e-6, busy_s=0.0)
    device_us: Dict[str, float] = defaultdict(float)
    ops_us: Dict[str, float] = defaultdict(float)
    busy: List[Tuple[float, float]] = []
    for s, e, name, corr in device:
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        busy.append((s, e))
        ops_us[name] += e - s
        hit = launch.get(corr)
        if hit is None:
            tl.unattributed += 1
            continue
        t_launch, tid = hit
        if tid != host_tid:
            continue
        for rname, rr in by_name.items():
            if rr.covering(t_launch) is not None:
                device_us[rname] += e - s
    busy = _merge(busy)
    tl.busy_s = sum(e - s for s, e in busy) * 1e-6
    tl.device_s = {k: v * 1e-6 for k, v in device_us.items()}
    tl.ops_s = {k: v * 1e-6 for k, v in ops_us.items()}

    host_ops = sorted(ops.get(host_tid, []))
    op_starts = [s for s, _, _ in host_ops]
    segments = _innermost_segments(
        [(s, e, name) for (name, tid), spans in ranges.items()
         if tid == host_tid for s, e in spans], w0, w1)
    seg_starts = [s for s, _, _ in segments]
    idle_us: Dict[str, float] = defaultdict(float)
    gaps: List[Tuple[float, str, float]] = []
    edges = [w0] + [t for iv in busy for t in iv] + [w1]
    j = 0
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        # Each stretch of the gap goes to the range innermost meanwhile.
        while j < len(segments) and segments[j][1] <= g0:
            j += 1
        k = j
        while k < len(segments) and segments[k][0] < g1:
            s, e, label = segments[k]
            idle_us[label] += min(e, g1) - max(s, g0)
            k += 1
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(seg_starts, mid) - 1
        gaps.append((g1 - g0, segments[i][2] if i >= 0 else OUTSIDE, mid))
    tl.idle_s = {k: v * 1e-6 for k, v in idle_us.items()}
    gaps.sort(reverse=True)
    tl.longest_gaps = [(us * 1e-6, label, _op_at(host_ops, op_starts, mid))
                       for us, label, mid in gaps[:n_gaps]]
    return tl


def _innermost_segments(spans: List[Tuple[float, float, str]], w0: float,
                        w1: float) -> List[Tuple[float, float, str]]:
    """Cut [w0, w1] into pieces, each labelled with the innermost of the
    nested host ranges ``spans`` open over it (:data:`OUTSIDE` where none
    is)."""
    # Ends before starts at one instant; of two starts, the longer first.
    marks = sorted([(e, 0, 0.0, name) for s, e, name in spans]
                   + [(s, 1, s - e, name) for s, e, name in spans])
    out: List[Tuple[float, float, str]] = []
    stack: List[str] = []
    t = w0
    for when, is_start, _, name in marks:
        cut = min(max(when, w0), w1)
        if cut > t:
            out.append((t, cut, stack[-1] if stack else OUTSIDE))
            t = cut
        if is_start:
            stack.append(name)
        elif name in stack:
            del stack[len(stack) - 1 - stack[::-1].index(name)]
    if t < w1:
        out.append((t, w1, stack[-1] if stack else OUTSIDE))
    return out


def _op_at(host_ops, op_starts, t: float) -> str:
    """The innermost host operation open at ``t``, or ``""``."""
    i = bisect.bisect_right(op_starts, t) - 1
    best, best_len = "", None
    lo = max(0, i - 256)
    for s, e, name in host_ops[lo:i + 1]:
        if s <= t <= e and (best_len is None or e - s < best_len):
            best, best_len = name, e - s
    return best


def profile(run_calls: Callable[[Callable[[], None]], int]) -> Timeline:
    """Trace ``run_calls(mark)``, which makes its calls inside ``mark()``
    contexts and returns how many it made, on the CPU and the card, and
    read the trace back. The trace file goes to ``TMPDIR`` and is deleted
    once read."""
    import torch
    from torch.profiler import ProfilerActivity, record_function

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        with record_function(STRETCH):
            calls = run_calls(lambda: record_function(CALL))
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return read(events, calls)


def profiled_calls(call: Callable[[], None], max_calls: int,
                   max_seconds: float) -> Callable[[Callable], int]:
    """A ``run_calls`` for :func:`profile`: ``call()`` repeated until
    ``max_calls`` calls or ``max_seconds`` seconds, whichever comes
    first."""
    def run_calls(mark: Callable) -> int:
        end = time.perf_counter() + max_seconds
        n = 0
        while n < max_calls and time.perf_counter() < end:
            with mark():
                call()
            n += 1
        return n
    return run_calls
