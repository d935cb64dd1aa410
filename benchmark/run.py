"""
Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up makes the rows and the query pool from the seed on the card
(``recipes/``), builds the configuration's index through its public
``build_index`` and warms up the cell's batch shape; the loop
(``loops/``) then drives ``nn_many`` for ``--seconds``. With ``--trace
1`` a bounded stretch of further calls is profiled (``trace.py``). Once
the window has closed and the peak device memory is read, the index is
freed and a seeded sample of the window's answers is compared with the
plain reference (``references/``). The last line of standard output is
one JSON object; the numbers compared, each beside its limit, are the
last lines of standard error and the last key of that object.

No card, or fewer than the cell asks for: exit 2, no result. A run that
loaded JAX or the JAX package: exit 3, no result.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from typing import Any, Dict, List, Optional, Sequence, Tuple  # noqa: E402

from benchmark import guard, peaks, registry, trace  # noqa: E402
from benchmark.sampler import Reservoir  # noqa: E402

#: The traced stretch: at most this many calls, or seconds.
STRETCH_CALLS = 200
STRETCH_SECONDS = 3.0


@dataclass
class Run:
    """What one run measured; each metric reader takes it."""
    config: dict
    traffic: dict
    seconds: float
    setup_s: float = 0.0
    #: (start, end, queries) of each call that ended inside the window.
    calls: List[Tuple[float, float, int]] = field(default_factory=list)
    failed: int = 0
    #: ``utils.tracing.COUNTERS`` over the window (reset after warm-up).
    counters: Dict[str, float] = field(default_factory=dict)
    #: Collections inside the window, by generation: count and seconds.
    gc_counts: List[int] = field(default_factory=lambda: [0, 0, 0])
    gc_seconds: List[float] = field(default_factory=lambda: [0.0] * 3)
    timeline: Optional[trace.Timeline] = None
    #: Set-up's parts in order, seconds.
    setup_parts: Dict[str, float] = field(default_factory=dict)
    #: The harness's own seconds between calls in the window.
    between_s: float = 0.0
    check: Dict[str, Any] = field(default_factory=dict)


class GcWatch:
    """Times the collector through ``gc.callbacks`` while entered."""

    def __init__(self, run: Run):
        self.run = run
        self._t0: Optional[float] = None

    def __call__(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        elif self._t0 is not None:
            g = info["generation"]
            self.run.gc_seconds[g] += time.perf_counter() - self._t0
            self.run.gc_counts[g] += 1
            self._t0 = None

    def __enter__(self) -> "GcWatch":
        gc.callbacks.append(self)
        return self

    def __exit__(self, *exc) -> None:
        gc.callbacks.remove(self)


def _log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def _index_class(path: str):
    module, _, name = path.rpartition(".")
    return getattr(importlib.import_module(module), name)


def run_cell(cell: dict, config: dict, traffic: dict, metrics: List[dict],
             seed: int, seconds: float, trace_on: bool,
             device: str = "cuda", t0: float = T0) -> dict:
    """Run ``cell`` once; its result object (the module docstring)."""
    import torch

    from smqtk_indexing_tpu_torch.data.descriptor import (
        DescriptorMemoryElement,
    )
    from smqtk_indexing_tpu_torch.utils.tracing import COUNTERS

    recipe = registry.load_module("recipes", config["data"]["recipe"])
    loop = registry.load_module("loops", traffic["loop"])
    reference = registry.load_module("references",
                                     config["check"]["reference"])
    readers = {m["name"]: registry.load_module("metrics", m["name"])
               for m in metrics}
    # The program's defaults: none of its switches is set.
    for key in [k for k in os.environ if k.startswith("SMQTK_TPU_")]:
        del os.environ[key]
    on_card = device.startswith("cuda")
    chips = range(int(cell["chips"]))
    run = Run(config=config, traffic=traffic, seconds=seconds)

    batch, k = int(traffic["batch"]), int(traffic["k"])
    if int(traffic["pool"]) % batch:
        raise ValueError("the query pool must be whole batches")
    stamps = [("imports", time.perf_counter())]
    rows, pool = recipe.make(config["data"], int(traffic["pool"]), seed,
                             device)
    stamps.append(("rows and queries", time.perf_counter()))
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        for c in chips:
            torch.cuda.reset_peak_memory_stats(c)
    index = _index_class(config["index"]["class"])(
        **config["index"]["kwargs"], device=device)
    index.build_index([DescriptorMemoryElement(i, rows[i])
                       for i in range(rows.shape[0])])
    queries = [DescriptorMemoryElement(-1 - i, pool[i])
               for i in range(pool.shape[0])]
    batches = [queries[lo:lo + batch]
               for lo in range(0, len(queries), batch)]
    stamps.append(("elements and build", time.perf_counter()))
    errors: List[str] = []

    def call(b: Sequence) -> Optional[list]:
        try:
            return index.nn_many(b, k)
        except Exception:                        # counted as failed
            errors.append(traceback.format_exc() if not errors else "")
            return None

    for i in range(int(traffic["warmup_calls"])):
        call(batches[i % len(batches)])
    if on_card:
        torch.cuda.synchronize()
    stamps.append(("warm-up", time.perf_counter()))
    COUNTERS.reset()
    sample = Reservoir(int(config["check"]["sample"]), seed)

    def on_result(i: int, b: Sequence, out: Optional[list]) -> None:
        t = time.perf_counter()
        base = (i % len(batches)) * batch
        got = out or []
        if out is None:
            run.failed += len(b)

        def answer(j: int):
            if j >= len(got):
                return base + j, None, None
            elems, dists = got[j]
            return base + j, [e.uuid() for e in elems], list(dists)
        sample.offer(len(b), answer)
        run.between_s += time.perf_counter() - t

    with GcWatch(run):
        start, run.calls, nxt = loop.run(
            call, batches, seconds, on_result,
            first=int(traffic["warmup_calls"]))
        run.counters = COUNTERS.snapshot()
    run.setup_s = start - t0
    run.setup_parts = {name: b - a for (_, a), (name, b)
                       in zip([("start", t0)] + stamps, stamps)}

    if trace_on:
        state = {"i": nxt}

        def one() -> None:
            call(batches[state["i"] % len(batches)])
            state["i"] += 1
        run.timeline = trace.profile(trace.profiled_calls(
            one, STRETCH_CALLS, STRETCH_SECONDS))
    # The fullest card's peak.
    peak = max(torch.cuda.max_memory_allocated(c) for c in chips) \
        if on_card else 0
    del index, queries, batches, call
    if on_card:
        torch.cuda.empty_cache()

    if errors:
        _log(f"{len(errors)} calls raised; the first:\n{errors[0]}")
    run.check = reference.compare(sample.items, rows, pool, k, device)
    limits = config["check"]["limits"]
    compared = {name: {"value": run.check[name], "limit": limit}
                for name, limit in limits.items()}
    correct = (bool(sample.items) and run.failed == 0 and not errors
               and all(c["value"] <= c["limit"] for c in compared.values()))

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result: Dict[str, Any] = {
        "correct": correct,
        "attempted": sum(c[2] for c in run.calls),
        "failed": run.failed,
        "metrics": values,
        "device": _device(torch, on_card, len(chips), peak,
                          run.timeline),
    }
    _report(run, sample, result)
    if run.timeline is not None:
        tl = run.timeline
        result["breakdown"] = {
            "device_ops": sorted(tl.ops_s.items(),
                                 key=lambda x: -x[1])[:10],
            "idle_gaps": sorted(tl.idle_s.items(),
                                key=lambda x: -x[1])[:10]}
    result["check"] = compared
    for name, c in compared.items():
        _log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result


def _device(torch, on_card: bool, count: int, peak: int,
            timeline: Optional[trace.Timeline]) -> dict:
    if on_card:
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": count, "memory_peak_bytes": int(peak),
               "power_limit_w": peaks.power_limit_w(0)}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0}
    if timeline is not None:
        dev["busy_s"] = timeline.busy_s
        dev["window_s"] = timeline.window_s
    return dev


def _report(run: Run, sample: Reservoir, result: dict) -> None:
    """The lines before the checks: what the numbers rest on."""
    dev = result["device"]
    _log(f"device {dev['kind']} power_limit_w {dev.get('power_limit_w')}")
    _log(f"setup_s {run.setup_s!r} window_s {run.seconds!r} "
         f"calls {len(run.calls)} (batch_p95_ms over {len(run.calls)} "
         f"samples) queries {result['attempted']} failed {run.failed}")
    _log("set-up seconds by part " + json.dumps(run.setup_parts))
    _log(f"harness work between calls in the window {run.between_s!r} s")
    if run.calls:
        ms = sorted(1e3 * (t1 - t0) for t0, t1, _ in run.calls)
        _log(f"call ms: min {ms[0]!r} median {ms[len(ms) // 2]!r} "
             f"max {ms[-1]!r}")
    spans = {name: 1e3 * run.counters.get(f"span.{name}.seconds", 0.0)
             / run.counters[f"span.{name}.calls"]
             for name in ("flat.query", "store.knn", "flat.assemble")
             if run.counters.get(f"span.{name}.calls")}
    _log(f"program spans, ms a call over the window: {spans}")
    _log(f"gc collections in the window by generation {run.gc_counts} "
         f"seconds {run.gc_seconds}")
    _log(f"answers compared {len(sample.items)} of {sample.seen}; "
         f"recall_at_10 {run.check.get('recall_at_10')!r}")
    tl = run.timeline
    if tl is not None:
        _log(f"traced stretch: {tl.calls} calls, window_s {tl.window_s!r} "
             f"busy_s {tl.busy_s!r}, device operations with no launch "
             f"found {tl.unattributed}")
        if run.calls and tl.window_s > 0:
            window = len(run.calls) / run.seconds
            _log(f"calls a second: traced stretch {tl.calls / tl.window_s!r}"
                 f" window {window!r} (stretch / window "
                 f"{tl.calls / tl.window_s / window!r})")
        _log("device seconds by host range "
             + json.dumps(dict(sorted(tl.device_s.items()))))
        for s, rng, op in tl.longest_gaps:
            _log(f"idle gap {s!r} s in {rng} / {op}")
    _log("metrics " + json.dumps(result["metrics"]))


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    spec = registry.load_spec()
    cell = registry.cell(spec, args.workload)
    config = registry.load_json("configs", cell["config"])
    traffic = registry.load_json("traffic", cell["traffic"])
    metrics = registry.metrics_for(spec, cell["name"], bool(args.trace))
    # The system under test: without it there is nothing to measure.
    _index_class(config["index"]["class"])

    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < int(cell["chips"]):
        _log(f"{cell['name']} needs {cell['chips']} CUDA card(s); "
             f"found {have}")
        return 2
    result = run_cell(cell, config, traffic, metrics, args.seed,
                      args.seconds, bool(args.trace))
    found = guard.forbidden_modules()
    if found:
        _log("the run loaded forbidden modules: " + ", ".join(found))
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
