"""A whole run of a cell, on the CPU at a tiny size with the card's look
skipped: the result line, and ``correct`` against a timed path broken in
each way the flat cells can break."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import registry, run
from benchmark.tests.conftest import tiny_cell
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)

SEED = 2 ** 31 + 977


def _run(trace=False, name="flat-gist1m.b1024"):
    cell, config, traffic, metrics = tiny_cell(name, trace=trace)
    return run.run_cell(cell, config, traffic, metrics, SEED, 0.3, trace,
                        device="cpu")


@pytest.mark.parametrize("name", ["flat-gist1m.b1024",
                                  "flat-deep10m.b1024", "flat-gist1m.b16"])
def test_a_sound_run_is_correct_and_reports_its_metrics(name):
    res = _run(name=name)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "check"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    spec = registry.load_spec()
    want = {m["name"] for m in registry.metrics_for(spec, name, False)}
    assert set(res["metrics"]) == want
    assert res["metrics"]["recall_at_10"]["value"] == 1.0
    assert res["check"]["malformed"] == {"value": 0, "limit": 0}
    json.dumps(res)


def test_a_traced_run_reports_per_layer_metrics():
    res = _run(trace=True)
    assert res["correct"] is True
    # The CPU runs no device operation: only the host's metrics read.
    assert set(res["metrics"]) == {"assemble_ms", "store_knn_ms",
                                   "gc_pause_ms"}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "check"


def _stale(real):
    """Every call returns the answers of the call before it."""
    last = {}

    def nn_many(self, ds, n=1):
        out = real(self, ds, n)
        prev, last["out"] = last.get("out", out), out
        return prev
    return nn_many


def _half(real):
    """Half of each batch is left out."""
    return lambda self, ds, n=1: real(self, ds, n)[:len(ds) // 2]


def _wrong_row(real):
    """Each answer's last neighbour is replaced by another row."""
    def nn_many(self, ds, n=1):
        out = []
        for elems, dists in real(self, ds, n):
            other = self.descriptor_set.get_descriptor(
                (elems[-1].uuid() + 1) % self.count())
            out.append((elems[:-1] + (other,), dists))
        return out
    return nn_many


def _wrong_distance(real):
    """Each answer's last distance is 1% too large."""
    def nn_many(self, ds, n=1):
        return [(elems, dists[:-1] + (dists[-1] * 1.01,))
                for elems, dists in real(self, ds, n)]
    return nn_many


def _raises(real):
    def nn_many(self, ds, n=1):
        raise RuntimeError("a broken kernel")
    return nn_many


@pytest.mark.parametrize("fault", [_stale, _half, _wrong_row,
                                   _wrong_distance, _raises])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    monkeypatch.setattr(FlatNearestNeighborsIndex, "_nn_many",
                        fault(FlatNearestNeighborsIndex._nn_many))
    res = _run()
    assert res["correct"] is False


def test_without_a_card_the_run_fails_and_prints_no_result(capsys):
    pytest.importorskip("torch")
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert run.main(["--workload", "flat-gist1m.b16", "--seed", "1",
                     "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_the_benchmark_alone_fails_without_the_program(tmp_path):
    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(registry.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "flat-gist1m.b16", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, env=env, capture_output=True, text=True,
        timeout=300)
    assert p.returncode != 0 and p.stdout == ""
    assert "smqtk_indexing_tpu_torch" in p.stderr
