"""Shared pieces of the benchmark's tests, which run on the CPU; those
marked ``cuda`` need a card and skip without one (on the card: ``python3
-m pytest -p no:cacheprovider --confcutdir=benchmark -q -m cuda
benchmark/tests``)."""
import copy

import pytest

from benchmark import registry


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips without one")


@pytest.fixture
def card():
    """Skips the test without a CUDA card; decided when the test runs."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny_cell(name: str = "flat-gist1m.b1024", n: int = 3000,
              dim: int = 96, batch: int = 32, trace: bool = False):
    """A cell of BENCHMARK.json cut to a size the CPU runs in a second:
    (cell, config, traffic, metrics)."""
    spec = registry.load_spec()
    cell = registry.cell(spec, name)
    config = copy.deepcopy(registry.load_json("configs", cell["config"]))
    config["data"].update(n=n, dim=dim, clusters=16)
    traffic = dict(registry.load_json("traffic", cell["traffic"]),
                   batch=batch, pool=4 * batch, warmup_calls=2)
    return cell, config, traffic, registry.metrics_for(spec, name, trace)
