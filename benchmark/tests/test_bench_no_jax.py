"""No module a run loads has the top-level name ``jax``, ``jaxlib``,
``flax`` or ``smqtk_indexing_tpu``. Checked in a fresh interpreter, since
this test process has loaded JAX for the repository's other tests."""
import json
import subprocess
import sys

from benchmark import guard, registry

_SCRIPT = r"""
import json, sys
import benchmark.run
from benchmark import guard, registry
from benchmark.run import _index_class
loaded = []
for kind in ("metrics", "recipes", "loops", "references"):
    for path in sorted((registry.HERE / kind).glob("*.py")):
        registry.load_module(kind, path.stem)
        loaded.append(f"{kind}/{path.name}")
for kind in ("configs", "traffic"):
    for path in sorted((registry.HERE / kind).glob("*.json")):
        body = registry.load_json(kind, path.stem)
        loaded.append(f"{kind}/{path.name}")
        if kind == "configs":
            _index_class(body["index"]["class"])
import benchmark.control, benchmark.trace
print(json.dumps({"loaded": loaded, "forbidden": guard.forbidden_modules(),
                  "port": "smqtk_indexing_tpu_torch" in sys.modules}))
"""


def test_nothing_the_harness_loads_is_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=registry.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr
    got = json.loads(p.stdout.strip().splitlines()[-1])
    assert got["forbidden"] == []
    assert got["port"] is True
    spec = registry.load_spec()
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert f"metrics/{m['name']}.py" in got["loaded"]
    for c in spec["configs"]:
        assert c["file"].replace("benchmark/", "") in got["loaded"]


def test_the_guard_compares_whole_top_level_names():
    names = ["smqtk_indexing_tpu_torch", "smqtk_indexing_tpu_torch.ops",
             "jaxtyping", "flax_like", "numpy"]
    assert guard.forbidden_modules(names) == []
    bad = ["jax", "jax.numpy", "jaxlib.xla_client", "flax",
           "smqtk_indexing_tpu", "smqtk_indexing_tpu.ops.store"]
    assert guard.forbidden_modules(names + bad) == sorted(bad)
