"""
The port's hash indexes (``models/hash_index/``: ``LinearHashIndex`` and
``BallTreeHashIndex``) against the JAX package's, driven through the same
calls on the same seeded codes: build (deduplicated), update, remove,
``nn`` / ``nn_many`` (normalized Hamming), the cache payload in both
directions, configuration round-trips and the registry's bare names.
"""
import json

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataElement,
)
from smqtk_indexing_tpu.models.hash_index import (
    BallTreeHashIndex as JaxBallTree, LinearHashIndex as JaxLinear,
)
from smqtk_indexing_tpu_torch.core.configuration import (
    configuration_test_helper, from_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.interfaces.hash_index import HashIndex
from smqtk_indexing_tpu_torch.models.hash_index import (
    BallTreeHashIndex, LinearHashIndex,
)
from smqtk_indexing_tpu_torch.utils.bits import int_to_bit_vector_large

torch.set_num_threads(1)

PAIRS = [(LinearHashIndex, JaxLinear), (BallTreeHashIndex, JaxBallTree)]
IDS = ["linear", "balltree"]


def _codes(n, width, seed):
    return np.random.default_rng(seed).integers(
        0, 2, size=(n, width)).astype(bool)


def _same_results(res, ref):
    assert len(res) == len(ref)
    for (codes, dists), (codes_ref, dists_ref) in zip(res, ref):
        assert np.array_equal(codes, codes_ref)
        assert dists == dists_ref


@pytest.mark.parametrize("cls,jax_cls", PAIRS, ids=IDS)
@pytest.mark.parametrize("n", [1500, 5000])
def test_lifecycle_matches_jax(cls, jax_cls, n):
    # 5000 codes take the XOR route on both (the JAX store's ±1 route
    # needs a TPU; the port's starts at 16384); 1500 the host scan.
    width = 24
    mat = _codes(n, width, seed=n)
    extra = _codes(300, width, seed=n + 1)
    q = np.vstack([mat[:3], extra[:2], _codes(5, width, seed=n + 2)])
    port, ref = cls(device="cpu"), jax_cls()
    for index in (port, ref):
        index.build_index(np.vstack([mat, mat[:100]]))   # duplicates
    assert port.count() == ref.count() == len(np.unique(mat, axis=0))
    _same_results(port.nn_many(q, 7), ref.nn_many(q, 7))
    for index in (port, ref):
        index.update_index(extra)
        index.remove_from_index(mat[10:400])
    assert port.count() == ref.count()
    _same_results(port.nn_many(q, 7), ref.nn_many(q, 7))
    codes, dists = port.nn(q[0], 4)
    assert dists[0] == 0.0 and np.array_equal(codes[0], q[0])
    _same_results([port.nn(q[6], 4)], [ref.nn(q[6], 4)])
    assert all(0.0 <= d <= 1.0 for _, ds in port.nn_many(q, 3) for d in ds)


@pytest.mark.parametrize("cls", [LinearHashIndex, BallTreeHashIndex],
                         ids=IDS)
def test_contract_probes(cls):
    index = cls(device="cpu")
    with pytest.raises(ValueError):
        index.build_index([])
    with pytest.raises(ValueError):
        index.nn(np.zeros(8, bool))
    index.build_index(_codes(20, 8, seed=1))
    before = index.count()
    present = _codes(1, 8, seed=1)
    missing = next(int_to_bit_vector_large(i, 8) for i in range(256)
                   if not index._store.has_int(i))
    with pytest.raises(KeyError):
        index.remove_from_index(np.vstack([present, missing]))
    assert index.count() == before
    codes, dists = index.nn(present[0], 100)           # more than indexed
    assert len(codes) == before and dists == tuple(sorted(dists))


@pytest.mark.parametrize("cls,jax_cls", PAIRS, ids=IDS)
def test_cache_payload_both_ways(cls, jax_cls):
    mat = _codes(3000, 40, seed=5)
    q = _codes(6, 40, seed=6)
    port_elem, jax_elem = DataMemoryElement(), JaxDataElement()
    port = cls(cache_element=port_elem, device="cpu")
    ref = jax_cls(cache_element=jax_elem)
    for index in (port, ref):
        index.build_index(mat)
        index.remove_from_index(mat[:30])
    # Write-through on every mutation; each package loads the other's.
    from_jax = cls(cache_element=DataMemoryElement(jax_elem.get_bytes()),
                   device="cpu")
    from_port = jax_cls(
        cache_element=JaxDataElement(port_elem.get_bytes()))
    assert from_jax.count() == from_port.count() == ref.count()
    _same_results(from_jax.nn_many(q, 5), ref.nn_many(q, 5))
    _same_results(from_port.nn_many(q, 5), port.nn_many(q, 5))
    ro = cls(cache_element=DataMemoryElement(readonly=True), device="cpu")
    with pytest.raises(Exception, match="read-only"):
        ro.build_index(mat[:5])


@pytest.mark.parametrize("cls", [LinearHashIndex, BallTreeHashIndex],
                         ids=IDS)
def test_configuration_and_registry(cls):
    index = cls(cache_element=DataMemoryElement(), device="cpu")
    for inst in configuration_test_helper(index):
        assert isinstance(inst, cls) and inst.device == "cpu"
    cfg = index.get_config()
    json.dumps(cfg)
    assert cfg["device"] == "cpu"
    impls = HashIndex.get_impls()
    assert {c.__name__ for c in impls} == {"LinearHashIndex",
                                           "BallTreeHashIndex"}
    name = cls.__name__
    inst = from_config_dict({"type": name, name: {"device": "cpu"}}, impls)
    assert type(inst) is cls
    report = cls.usability_report()
    assert report["class"] == name and report["usable"]


def test_refusals(monkeypatch):
    with pytest.raises(ValueError, match="power of two"):
        LinearHashIndex(n_devices=3, device="cpu")
    if not torch.cuda.is_available():
        for cls in (LinearHashIndex, BallTreeHashIndex):
            with pytest.raises(RuntimeError, match="cuda"):
                cls()
    monkeypatch.setenv("SMQTK_TPU_NO_MXU_HAMMING", "1")
    report = LinearHashIndex.usability_report()
    assert report["disabled_flags"] == ["SMQTK_TPU_NO_MXU_HAMMING"]
    assert report["degraded"]
