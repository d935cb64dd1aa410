"""
The port imports nothing of the JAX package and runs with jax blocked: in a
fresh interpreter where ``import jax`` fails, every module of
``smqtk_indexing_tpu_torch`` imports without loading any
``smqtk_indexing_tpu`` module, tiny CPU builds and queries of the flat,
IVF, LSH and MRPT indexes run (the SQ8, PQ and OPQ codecs included; ITQ
and a hash index too; the FAISS adapter and the autotuned index), ``get_impls()``
returns the port's classes with no failed plugin import, the bare class
names of a config resolve to them, and a file-backed key-value store the
JAX package wrote loads into the port's copy. A source scan pins that no
module of the port, ``chip_smoke.py`` or the card tests imports the JAX
package.
"""
import ast
import json
import os
import subprocess
import sys

import numpy as np
import torch

from smqtk_indexing_tpu.data.descriptor import (
    DescriptorMemoryElement as JaxDescriptorMemoryElement,
)
from smqtk_indexing_tpu.data.key_value import (
    FileKeyValueStore as JaxFileKeyValueStore,
)

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = r"""
import importlib, json, logging, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
logging.basicConfig(level=logging.WARNING)  # failed plugin imports -> stderr
import numpy as np
import torch
torch.set_num_threads(1)
import smqtk_indexing_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.data.key_value import FileKeyValueStore
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex)
from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
    IvfNearestNeighborsIndex)
from smqtk_indexing_tpu_torch.models.nn_index.mrpt import (
    MRPTNearestNeighborsIndex)
from smqtk_indexing_tpu_torch.models.nn_index.faiss_compat import (
    FaissNearestNeighborsIndex)
from smqtk_indexing_tpu_torch.models.nn_index.autotune import (
    AutotunedNearestNeighborsIndex)
from smqtk_indexing_tpu_torch.core.configuration import from_config_dict
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
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
        ("flat_pq", FlatNearestNeighborsIndex(dtype="pq4", device="cpu")),
        ("mrpt", MRPTNearestNeighborsIndex(num_trees=4, depth=2,
                                           random_seed=0, device="cpu")),
        ("faiss", FaissNearestNeighborsIndex(
            factory_string="IVF4,SQ8", ivf_nprobe=4, random_seed=0,
            device="cpu")),
        ("autotune", AutotunedNearestNeighborsIndex(device="cpu"))):
    index.build_index(els)
    res = index.nn_many(els[:4], 3)
    out[name] = [[r[0][0].uuid() for r in res], [r[1][0] for r in res]]
# The hashing slice: ITQ, then LSH (fused serve) and a hash index.
from smqtk_indexing_tpu_torch.models.lsh_functor.itq import ItqFunctor
from smqtk_indexing_tpu_torch.models.nn_index.lsh import (
    LSHNearestNeighborIndex)
from smqtk_indexing_tpu_torch.models.hash_index.linear import LinearHashIndex
functor = ItqFunctor(bit_length=8, random_seed=0, device="cpu")
functor.fit(els)
index = LSHNearestNeighborIndex(lsh_functor=functor,
                                distance_method="euclidean", device="cpu")
index.build_index(els)
res = index.nn_many(els[:4], 3)
out["lsh"] = [[r[0][0].uuid() for r in res], [r[1][0] for r in res]]
hi = LinearHashIndex(device="cpu")
hi.build_index(functor.get_hash_batch(x))
out["hash_index"] = [hi.count(), list(hi.nn(functor.get_hash(x[5]), 2)[1])]
# The port's registry holds the port's classes, so a bare class name
# resolves to them.
impls = NearestNeighborsIndex.get_impls()
out["impls"] = sorted(f"{c.__module__}.{c.__name__}" for c in impls)
out["bare"] = {
    bare: type(from_config_dict(
        {"type": bare, bare: {"device": "cpu"}}, impls)).__module__
    for bare in ("FlatNearestNeighborsIndex", "IvfNearestNeighborsIndex",
                 "MRPTNearestNeighborsIndex", "FaissNearestNeighborsIndex",
                 "AutotunedNearestNeighborsIndex")}
from smqtk_indexing_tpu_torch.interfaces import HashIndex, LshFunctor
for iface in (HashIndex, LshFunctor):
    for c in iface.get_impls():
        out["bare"][c.__name__] = type(from_config_dict(
            {"type": c.__name__, c.__name__: {"device": "cpu"}},
            iface.get_impls())).__module__
# A store the JAX package wrote: its elements load as the port's classes.
kvs = FileKeyValueStore(sys.argv[1], readonly=True)
out["kvs"] = {str(k): [type(v).__module__, v.uuid(), v.vector().tolist()]
              for k, v in kvs._table.items()}
out["loaded_jax"] = [n for n, m in sys.modules.items()
                     if m is not None and (n == "jax" or n.startswith("jax."))]
out["loaded_jax_package"] = [
    n for n, m in sys.modules.items() if m is not None and (
        n == "smqtk_indexing_tpu" or n.startswith("smqtk_indexing_tpu."))]
print(json.dumps(out))
"""

#: Files that run where jax is missing, and so import nothing of the JAX
#: package: the port, the card smoke run and the card tests.
_NO_JAX_PACKAGE = (
    sorted(os.path.relpath(os.path.join(d, f), REPO)
           for d, _, fs in os.walk(os.path.join(REPO,
                                                "smqtk_indexing_tpu_torch"))
           for f in fs if f.endswith(".py"))
    + ["chip_smoke.py", "tests/test_torch_cuda.py"])


def _imported_modules(path):
    """Every module an import statement of ``path`` names."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_port_file_imports_the_jax_package():
    assert "smqtk_indexing_tpu_torch/ops/sq8.py" in _NO_JAX_PACKAGE
    assert "smqtk_indexing_tpu_torch/tools/probe_int8_mxu.py" \
        in _NO_JAX_PACKAGE
    assert "smqtk_indexing_tpu_torch/tools/stage1_analysis.py" \
        in _NO_JAX_PACKAGE
    for name in ("capacity_tiers", "ivf_100m", "ivf_400m"):
        assert f"smqtk_indexing_tpu_torch/examples/{name}.py" \
            in _NO_JAX_PACKAGE
    bad = [(path, mod) for path in _NO_JAX_PACKAGE
           for mod in _imported_modules(path)
           if mod == "smqtk_indexing_tpu"
           or mod.startswith("smqtk_indexing_tpu.")
           or mod == "jax" or mod.startswith("jax.")]
    assert bad == []


def test_port_runs_with_jax_blocked(tmp_path):
    kvs_path = str(tmp_path / "kvs.log")
    vecs = np.random.default_rng(1).normal(size=(3, 5))
    jax_kvs = JaxFileKeyValueStore(kvs_path)
    jax_kvs.add_many({i: JaxDescriptorMemoryElement(("u", i), vecs[i])
                      for i in range(3)})
    jax_kvs.remove(1)
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, kvs_path],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Failed" not in proc.stderr, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["loaded_jax_package"] == []
    assert out["kvs"] == {
        str(i): ["smqtk_indexing_tpu_torch.data.descriptor", ["u", i],
                 vecs[i].tolist()] for i in (0, 2)}
    for mod in ("models.nn_index.flat", "models.nn_index.ivf",
                "models.nn_index._ivf_code", "models.nn_index._ivf_rows",
                "models.nn_index._ivf_persist",
                "models.nn_index._ivf_matrix", "ops.fused_scan", "ops.ivf",
                "ops.ivf_scan", "ops.kmeans", "ops.sq8", "ops.pq",
                "ops.opq", "ops.store", "tools.probe_int8_mxu",
                "tools.stage1_analysis", "examples.capacity_100m",
                "models.nn_index.lsh", "models.hash_index.linear",
                "models.hash_index.block", "models.lsh_functor.itq",
                "models.lsh_functor.simple_rp", "ops.hamming", "ops.itq",
                "ops.lsh_fused", "ops.metrics", "native", "utils.bits",
                "examples.building_and_querying", "models.nn_index.mrpt",
                "models.nn_index.factory", "models.nn_index.faiss_compat",
                "models.nn_index.autotune", "ops.mrpt", "utils.metrics",
                "utils.parallel", "utils.progress_reporter",
                "examples.config_driven", "examples.capacity_tiers",
                "examples.ivf_100m", "examples.ivf_400m"):
        assert "smqtk_indexing_tpu_torch." + mod in out["modules"]
    assert out["loaded_jax"] == []
    assert out["flat"] == [[0, 1, 2, 3], [0.0] * 4]
    assert out["ivf"] == [[0, 1, 2, 3], [0.0] * 4]
    assert out["ivf_code"][0] == [0, 1, 2, 3]
    assert max(out["ivf_code"][1]) < 0.1      # the SQ8 step only
    assert out["flat_sq8"][0] == [0, 1, 2, 3]
    for name in ("mrpt", "autotune"):
        assert out[name] == [[0, 1, 2, 3], [0.0] * 4], name
    assert out["faiss"][0] == [0, 1, 2, 3]
    # PQ4 over 20 dims is lossy: every query still finds a neighbour.
    for name in ("ivf_opq", "ivf_pq_rows", "flat_pq"):
        assert len(out[name][0]) == 4 and all(
            d >= 0.0 for d in out[name][1]), name
    assert out["impls"] == [
        "smqtk_indexing_tpu_torch.models.nn_index.autotune."
        "AutotunedNearestNeighborsIndex",
        "smqtk_indexing_tpu_torch.models.nn_index.faiss_compat."
        "FaissNearestNeighborsIndex",
        "smqtk_indexing_tpu_torch.models.nn_index.flat."
        "FlatNearestNeighborsIndex",
        "smqtk_indexing_tpu_torch.models.nn_index.ivf."
        "IvfNearestNeighborsIndex",
        "smqtk_indexing_tpu_torch.models.nn_index.lsh."
        "LSHNearestNeighborIndex",
        "smqtk_indexing_tpu_torch.models.nn_index.mrpt."
        "MRPTNearestNeighborsIndex"]
    assert out["bare"] == {
        "FlatNearestNeighborsIndex":
            "smqtk_indexing_tpu_torch.models.nn_index.flat",
        "IvfNearestNeighborsIndex":
            "smqtk_indexing_tpu_torch.models.nn_index.ivf",
        "MRPTNearestNeighborsIndex":
            "smqtk_indexing_tpu_torch.models.nn_index.mrpt",
        "FaissNearestNeighborsIndex":
            "smqtk_indexing_tpu_torch.models.nn_index.faiss_compat",
        "AutotunedNearestNeighborsIndex":
            "smqtk_indexing_tpu_torch.models.nn_index.autotune",
        "LinearHashIndex": "smqtk_indexing_tpu_torch.models.hash_index.linear",
        "BallTreeHashIndex":
            "smqtk_indexing_tpu_torch.models.hash_index.block",
        "ItqFunctor": "smqtk_indexing_tpu_torch.models.lsh_functor.itq",
        "SimpleRPFunctor":
            "smqtk_indexing_tpu_torch.models.lsh_functor.simple_rp"}
    assert out["lsh"] == [[0, 1, 2, 3], [0.0] * 4]
    assert out["hash_index"][0] > 1 and out["hash_index"][1][0] == 0.0
