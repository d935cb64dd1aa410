"""Cells find their parts by name, so a new configuration, traffic mix or
metric is new files only; and BENCHMARK.json keeps to its format."""
import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark import registry, run

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
E2E_SOURCES = {"host_clock", "device_trace"}
SOURCES = E2E_SOURCES | {"program_span", "program_counter"}


@pytest.fixture
def base(tmp_path):
    """A copy of the benchmark's folder to add files to."""
    dst = tmp_path / "benchmark"
    shutil.copytree(registry.HERE, dst,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dst


def test_a_new_config_mix_and_metric_are_found_by_name(base):
    cfg = json.loads((base / "configs" / "flat-f32-gist1m.json").read_text())
    cfg.update(name="flat-f32-new", data=dict(cfg["data"], n=5000))
    (base / "configs" / "flat-f32-new.json").write_text(json.dumps(cfg))
    (base / "traffic" / "closed-b7.json").write_text(json.dumps(
        {"name": "closed-b7", "loop": "closed", "batch": 7, "k": 10,
         "pool": 70, "warmup_calls": 1}))
    (base / "metrics" / "calls_seen.v2.py").write_text(
        "def read(run):\n    return float(len(run.calls))\n")
    assert registry.load_json("configs", "flat-f32-new", base)["data"][
        "n"] == 5000
    assert registry.load_json("traffic", "closed-b7", base)["batch"] == 7
    mod = registry.load_module("metrics", "calls_seen.v2", base)
    r = run.Run(config=cfg, traffic={}, seconds=1.0,
                calls=[(0.0, 1.0, 7)] * 3)
    assert mod.read(r) == 3.0
    # The files already there are untouched and still found.
    assert registry.load_module("metrics", "qps", base).read(r) == 21.0


@pytest.mark.parametrize("kind,name", [
    ("configs", "no-such-config"), ("traffic", "../configs/x"),
    ("traffic", "a b")])
def test_unknown_or_malformed_names_are_refused(kind, name):
    with pytest.raises((FileNotFoundError, ValueError)):
        registry.load_json(kind, name)


def test_metrics_for_a_cell_follow_their_workloads():
    spec = {"end_to_end": [
                {"name": "qps", "moves": None},
                {"name": "tail", "workloads": ["a"]}],
            "per_layer": [
                {"name": "everywhere", "moves": "qps"},
                {"name": "only_b", "moves": "qps", "workloads": ["b"]},
                {"name": "with_tail", "moves": "tail"}]}
    names = lambda cell, tr: [m["name"] for m in  # noqa: E731
                              registry.metrics_for(spec, cell, tr)]
    assert names("a", False) == ["qps", "tail"]
    assert names("b", False) == ["qps"]
    assert names("a", True) == ["everywhere", "with_tail"]
    assert names("b", True) == ["everywhere", "only_b"]


def test_benchmark_json_keeps_to_its_format():
    spec = registry.load_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and 1 <= spec["run_seconds"] <= 51
    root = registry.ROOT
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.fullmatch(c["name"]) and c["file"].startswith(
            "benchmark/")
        body = json.loads((root / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == c["reduced"]
        assert len(c["source"]) <= 200 and len(c["why"]) <= 200
    configs = {c["name"] for c in spec["configs"]}
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        registry.load_json("traffic", w["traffic"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.fullmatch(m["name"]) and UNIT.fullmatch(m["unit"])
        assert m["better"] in ("lower", "higher")
        registry.load_module("metrics", m["name"])
    for m in spec["end_to_end"]:
        assert m["source"] in E2E_SOURCES and 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert m["source"] in SOURCES and m["moves"] in e2e
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
    for w in spec["workloads"]:
        got = {m["name"] for m in registry.metrics_for(spec, w["name"],
                                                       False)}
        assert "setup_s" in got and len(got) >= 2
        assert registry.metrics_for(spec, w["name"], True)
    assert len(json.dumps(spec)) < 64 * 1024
    assert all(Path(root, p).is_dir() for p in spec["paths"])
