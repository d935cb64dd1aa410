"""
The port imports and runs with jax blocked: every module of
``smqtk_indexing_tpu_torch`` imports, and a tiny CPU build and query run,
in a fresh interpreter where ``import jax`` fails.
"""
import json
import os
import subprocess
import sys

import torch

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import numpy as np
import torch
torch.set_num_threads(1)
import smqtk_indexing_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex)
rng = np.random.default_rng(0)
x = rng.normal(size=(300, 20)).astype(np.float32)
els = [DescriptorMemoryElement(i, x[i]) for i in range(300)]
index = FlatNearestNeighborsIndex(device="cpu")
index.build_index(els)
res = index.nn_many(els[:4], 3)
loaded = [n for n, m in sys.modules.items()
          if m is not None and (n == "jax" or n.startswith("jax."))]
print(json.dumps({"modules": mods, "loaded_jax": loaded,
                  "first": [r[0][0].uuid() for r in res],
                  "dists": [r[1][0] for r in res]}))
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "smqtk_indexing_tpu_torch.models.nn_index.flat" in out["modules"]
    assert "smqtk_indexing_tpu_torch.ops.fused_scan" in out["modules"]
    assert out["loaded_jax"] == []
    assert out["first"] == [0, 1, 2, 3]
    assert out["dists"] == [0.0] * 4
