"""
The port imports and runs with jax blocked: every module of
``smqtk_indexing_tpu_torch`` imports, tiny CPU builds and queries of the
flat and IVF indexes run (the SQ8, PQ and OPQ codecs included), and the bare class names of a config resolve to
the port's classes, in a fresh interpreter where ``import jax`` fails.
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
from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
    IvfNearestNeighborsIndex)
from smqtk_indexing_tpu.core.configuration import from_config_dict
from smqtk_indexing_tpu.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex)
rng = np.random.default_rng(0)
x = rng.normal(size=(300, 20)).astype(np.float32)
els = [DescriptorMemoryElement(i, x[i]) for i in range(300)]
out = {"modules": mods}
for name, index in (
        ("flat", FlatNearestNeighborsIndex(device="cpu")),
        ("ivf", IvfNearestNeighborsIndex(n_lists=4, nprobe=4, random_seed=0,
                                         device="cpu")),
        ("ivf_code", IvfNearestNeighborsIndex(
            n_lists=4, nprobe=4, random_seed=0, dtype="sq8",
            storage="code", device="cpu")),
        ("ivf_opq", IvfNearestNeighborsIndex(
            n_lists=4, nprobe=4, random_seed=0, dtype="opq4",
            storage="code", pq_residual=True, device="cpu")),
        ("ivf_pq_rows", IvfNearestNeighborsIndex(
            n_lists=4, nprobe=4, random_seed=0, dtype="pq4", device="cpu")),
        ("flat_sq8", FlatNearestNeighborsIndex(dtype="sq8", device="cpu")),
        ("flat_pq", FlatNearestNeighborsIndex(dtype="pq4", device="cpu"))):
    index.build_index(els)
    res = index.nn_many(els[:4], 3)
    out[name] = [[r[0][0].uuid() for r in res], [r[1][0] for r in res]]
# With jax blocked only the port's classes exist, so a bare class name
# resolves to them.
impls = NearestNeighborsIndex.get_impls()
out["bare"] = {
    bare: type(from_config_dict(
        {"type": bare, bare: {"device": "cpu"}}, impls)).__module__
    for bare in ("FlatNearestNeighborsIndex", "IvfNearestNeighborsIndex")}
out["loaded_jax"] = [n for n, m in sys.modules.items()
                     if m is not None and (n == "jax" or n.startswith("jax."))]
print(json.dumps(out))
"""


def test_port_runs_with_jax_blocked():
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    for mod in ("models.nn_index.flat", "models.nn_index.ivf",
                "models.nn_index._ivf_code", "models.nn_index._ivf_rows",
                "models.nn_index._ivf_persist",
                "models.nn_index._ivf_matrix", "ops.fused_scan", "ops.ivf",
                "ops.ivf_scan", "ops.kmeans", "ops.sq8", "ops.pq",
                "ops.opq", "ops.store"):
        assert "smqtk_indexing_tpu_torch." + mod in out["modules"]
    assert out["loaded_jax"] == []
    assert out["flat"] == [[0, 1, 2, 3], [0.0] * 4]
    assert out["ivf"] == [[0, 1, 2, 3], [0.0] * 4]
    assert out["ivf_code"][0] == [0, 1, 2, 3]
    assert max(out["ivf_code"][1]) < 0.1      # the SQ8 step only
    assert out["flat_sq8"][0] == [0, 1, 2, 3]
    # PQ4 over 20 dims is lossy: every query still finds a neighbour.
    for name in ("ivf_opq", "ivf_pq_rows", "flat_pq"):
        assert len(out[name][0]) == 4 and all(
            d >= 0.0 for d in out[name][1]), name
    assert out["bare"] == {
        "FlatNearestNeighborsIndex":
            "smqtk_indexing_tpu_torch.models.nn_index.flat",
        "IvfNearestNeighborsIndex":
            "smqtk_indexing_tpu_torch.models.nn_index.ivf"}
