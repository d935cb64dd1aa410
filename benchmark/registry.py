"""
Find a cell's parts by name. Each configuration, traffic mix, recipe,
loop, reference and metric is a file of its own under this folder, named
after the name that ``BENCHMARK.json`` (or a configuration or traffic
file) gives it, so adding one adds a file and edits none.
"""
from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
#: Names in BENCHMARK.json: a letter, digit or ``_``, then at most 63 of
#: letters, digits, ``_``, ``.`` and ``-``.
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")


def _path(kind: str, name: str, suffix: str, base: Path) -> Path:
    if not isinstance(name, str) or not NAME.fullmatch(name):
        raise ValueError(f"{kind}: {name!r} is not a valid name")
    path = base / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"{kind}: no {path}")
    return path


def load_json(kind: str, name: str, base: Path = HERE) -> dict:
    """``<base>/<kind>/<name>.json`` (``kind``: ``configs``, ``traffic``)."""
    with open(_path(kind, name, ".json", base)) as f:
        return json.load(f)


def load_module(kind: str, name: str, base: Path = HERE) -> ModuleType:
    """Import ``<base>/<kind>/<name>.py`` (``kind``: ``metrics``,
    ``recipes``, ``loops``, ``references``) once a process, under a
    module name that no two files share."""
    path = _path(kind, name, ".py", base)
    modname = f"benchmark_{kind}:{path}"
    if modname in sys.modules:
        return sys.modules[modname]
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[modname] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[modname]
        raise
    return mod


def load_spec(root: Path = ROOT) -> dict:
    """``BENCHMARK.json`` at the root of the checkout."""
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    """The entry of ``workloads`` named ``name``.

    :raises KeyError: no such cell.
    """
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def metrics_for(spec: dict, name: str, trace: bool) -> List[dict]:
    """The metrics a run of cell ``name`` reports: its end-to-end metrics
    with tracing off, its per-layer metrics with tracing on. A metric
    without ``workloads`` belongs to every cell; a per-layer one without
    it, to every cell that reports the end-to-end metric it moves."""
    def listed(m: dict) -> bool:
        return name in m.get("workloads", (name,))

    e2e = [m for m in spec["end_to_end"] if listed(m)]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if listed(m) and (m.get("workloads") or m["moves"] in reported)]
