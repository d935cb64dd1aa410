"""
The port's front ends on the CPU: the FAISS-style factory
(``models/nn_index/factory.py``), the FAISS-wrapper adapter
(``faiss_compat.FaissNearestNeighborsIndex``), the FLANN-parity autotuned
index (``autotune.AutotunedNearestNeighborsIndex``), the three public
utils (``utils/metrics.py``, ``parallel.py``, ``progress_reporter.py``)
and ``examples/config_driven.py``.

The cases are those of ``tests/impls/nn_index/test_flat.py:340-390``,
``test_faiss_compat.py`` and ``test_autotune.py``, run on the port, with
the JAX package beside it where a case compares: the factory maps each
string to the same class and options, the adapter's answers equal the JAX
adapter's on the same trained state (its index payload carried across),
and the exact autotuned scans equal the JAX index's. The JAX autotune
builds are slow on the CPU, so the calibrated cases run on the port alone.
"""
import json
import logging
import warnings

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import autotune as jax_autotune
from smqtk_indexing_tpu.models.nn_index import factory as jax_factory
from smqtk_indexing_tpu.models.nn_index import faiss_compat as jax_faiss
from smqtk_indexing_tpu.utils import metrics as jax_metrics
from smqtk_indexing_tpu_torch.core.configuration import (
    configuration_test_helper, from_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorMemoryElement, MemoryDescriptorSet,
)
from smqtk_indexing_tpu_torch.data.key_value import MemoryKeyValueStore
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.autotune import (
    AutotunedNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.factory import (
    index_from_factory_string,
)
from smqtk_indexing_tpu_torch.models.nn_index.faiss_compat import (
    FaissNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.flat import (
    FlatNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
    IvfNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.utils import metrics
from smqtk_indexing_tpu_torch.utils.parallel import parallel_map
from smqtk_indexing_tpu_torch.utils.progress_reporter import ProgressReporter
from tests.test_torch_helpers import assert_same_neighbours, elements_for

torch.set_num_threads(1)

EXACT_TOL = (1e-5, 1e-5)


def _els(n, d, seed=0):
    rng = np.random.default_rng(seed)
    return [DescriptorMemoryElement(i, rng.normal(size=d).astype(np.float32))
            for i in range(n)]


def _answers(index, queries, k):
    res = index.nn_many(elements_for(index, queries), k)
    return (np.array([[e.uuid() for e in r[0]] for r in res]),
            np.array([r[1] for r in res], dtype=np.float64))


# ---------------------------------------------------------------------------
# factory strings
# ---------------------------------------------------------------------------

FACTORY_CASES = [
    ("Flat", "l2", {}), ("IDMap,Flat", "ip", {}), ("SQ8", "l2", {}),
    ("SQfp16", "l2", {}), ("PQ8", "l2", {}), ("PQ8x8", "cosine", {}),
    ("OPQ8,PQ8", "l2", {}), ("IVF8,SQfp16", "l2", {}),
    ("IVF4096,Flat", "l2", {"nprobe": 32}), ("IVF16,SQ8", "l2", {}),
    ("IVF16,PQ4", "l2", {}), ("IVF16,PQ4", "ip", {}),
    ("IVF16,PQ4", "cosine", {"storage": "code"}),
    ("OPQ4,IVF16,PQ4", "l2", {}),
    ("IVF16,PQ4", "l2", {"pq_residual": False}),
]


@pytest.mark.parametrize("fs,metric,kw", FACTORY_CASES)
def test_factory_maps_like_jax(fs, metric, kw):
    ref = jax_factory.index_from_factory_string(fs, metric=metric, **kw)
    out = index_from_factory_string(fs, metric=metric, device="cpu", **kw)
    assert type(out).__name__ == type(ref).__name__
    assert type(out).__module__.startswith("smqtk_indexing_tpu_torch.")
    assert out.device == "cpu"
    for attr in ("metric", "dtype", "n_lists", "nprobe", "storage",
                 "pq_residual"):
        assert getattr(out, attr, None) == getattr(ref, attr, None), attr


def test_factory_reference_cases():
    # tests/impls/nn_index/test_flat.py:340-390, on the port.
    kw = dict(device="cpu")
    assert index_from_factory_string("SQfp16", **kw).dtype == "bfloat16"
    i = index_from_factory_string("IVF8,SQfp16", **kw)
    assert i.dtype == "bfloat16" and i.n_lists == 8
    i = index_from_factory_string("IDMap,Flat", **kw)
    assert isinstance(i, FlatNearestNeighborsIndex)
    assert i.metric == "euclidean"
    assert index_from_factory_string("Flat", metric="ip", **kw).metric \
        == "inner_product"
    i = index_from_factory_string("IVF4096,Flat", nprobe=32, **kw)
    assert isinstance(i, IvfNearestNeighborsIndex)
    assert (i.n_lists, i.nprobe) == (4096, 32)


@pytest.mark.parametrize("fs,metric,match", [
    ("SQ4", "l2", "scalar quantizers"), ("SQ6", "l2", "scalar quantizers"),
    ("IVF8,SQ4", "l2", "scalar quantizers"),
    ("HNSW32,Flat", "l2", "Unsupported factory string"),
    ("Flat", "hamming", "Unsupported metric label"),
    ("OPQ8_64,PQ8", "l2", "dimension-reducing"),
    ("OPQ8,PQ4", "l2", "must match"), ("OPQ8,Flat", "l2", "followed by"),
    ("PQ8x4", "l2", "8-bit"),
])
def test_factory_errors_match_jax(fs, metric, match):
    with pytest.raises(ValueError, match=match) as ref:
        jax_factory.index_from_factory_string(fs, metric=metric)
    with pytest.raises(ValueError, match=match) as out:
        index_from_factory_string(fs, metric=metric, device="cpu")
    assert str(out.value) == str(ref.value)


# ---------------------------------------------------------------------------
# the FAISS-wrapper adapter
# ---------------------------------------------------------------------------

def _faiss(**kw):
    return FaissNearestNeighborsIndex(device="cpu", **kw)


def test_faiss_discoverable_and_reference_config():
    assert FaissNearestNeighborsIndex in NearestNeighborsIndex.get_impls()
    idx = _faiss(factory_string="IVF16,Flat", metric_type="l2",
                 ivf_nprobe=4, random_seed=0)
    cfg = json.loads(json.dumps(idx.get_config()))
    for key in ("descriptor_set", "uid2idx_kvs", "idx2uid_kvs",
                "factory_string", "metric_type", "ivf_nprobe",
                "read_only", "random_seed", "use_gpu", "gpu_id", "device"):
        assert key in cfg, key
    idx2 = FaissNearestNeighborsIndex.from_config(cfg)
    assert (idx2.factory_string, idx2.ivf_nprobe, idx2.device) == \
        ("IVF16,Flat", 4, "cpu")
    assert idx2._inner.device == "cpu"
    # A reference-shaped config (no 'device' key) places the index on the
    # card, so it raises here.
    if not torch.cuda.is_available():
        del cfg["device"]
        with pytest.raises(RuntimeError, match="cuda"):
            FaissNearestNeighborsIndex.from_config(cfg)


@pytest.mark.parametrize("fs,metric", [
    ("IDMap,Flat", "l2"), ("Flat", 0), ("SQ8", "l2"), ("IVF16,Flat", "l2"),
    ("IVF16,SQ8", "l2"), ("IVF16,PQ4", "l2"), ("OPQ4,IVF16,PQ4", "l2"),
])
def test_faiss_factory_strings_build_and_query(fs, metric):
    els = _els(300, 16, seed=3)
    idx = _faiss(factory_string=fs, metric_type=metric, ivf_nprobe=16,
                 random_seed=0)
    idx.build_index(els)
    assert idx.count() == 300
    got = [e.uuid() for e in idx.nn(els[11], 5)[0]]
    assert 11 in got, (fs, got)


@pytest.mark.parametrize("fs", ["IDMap,Flat", "IVF16,Flat", "IVF16,SQ8"])
def test_faiss_answers_equal_jax_on_its_payload(fs):
    els = _els(600, 16, seed=5)
    kw = dict(factory_string=fs, ivf_nprobe=4, random_seed=0)
    elem = JaxDataMemoryElement()
    ref = jax_faiss.FaissNearestNeighborsIndex(index_element=elem, **kw)
    ref.build_index(elements_for(ref, els))
    port = _faiss(index_element=DataMemoryElement(elem.get_bytes()), **kw)
    assert port.count() == 600
    u_p, d_p = _answers(port, els[:8], 10)
    u_r, d_r = _answers(ref, els[:8], 10)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)


def test_faiss_nprobe_is_query_time_tunable():
    els = _els(600, 16, seed=5)
    idx = _faiss(factory_string="IVF16,Flat", ivf_nprobe=16, random_seed=0)
    idx.build_index(els)
    full = idx.nn(els[3], 8)
    idx.ivf_nprobe = 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        narrow = idx.nn(els[3], 8)
    assert narrow[0][0].uuid() == 3 and full[0][0].uuid() == 3
    assert idx._inner.nprobe == 1


def test_faiss_three_store_layout_and_param_element():
    u2i, i2u = MemoryKeyValueStore(), MemoryKeyValueStore()
    pe, ie = DataMemoryElement(), DataMemoryElement()
    els = _els(100, 8, seed=9)
    idx = _faiss(descriptor_set=MemoryDescriptorSet(), uid2idx_kvs=u2i,
                 idx2uid_kvs=i2u, index_element=ie, index_param_element=pe,
                 factory_string="IVF16,Flat", random_seed=1)
    idx.build_index(els)
    assert u2i.count() == 100 and i2u.count() == 100
    params = json.loads(pe.get_bytes().decode())
    assert params["factory_string"] == "IVF16,Flat"
    idx2 = _faiss(descriptor_set=MemoryDescriptorSet(), index_element=ie,
                  index_param_element=pe, factory_string="IVF16,Flat",
                  random_seed=1)
    assert idx2.count() == 100
    assert idx2.nn(els[7], 3)[0][0].uuid() == 7


def test_faiss_use_gpu_warns_and_errors_match_reference(caplog):
    with pytest.warns(UserWarning, match="'device' argument"):
        _faiss(use_gpu=True, gpu_id=1)
    with pytest.raises(ValueError, match="factory_string"):
        _faiss(factory_string=7)
    for bad in ("hamming", 23):
        with pytest.raises(ValueError, match="metric type"):
            _faiss(metric_type=bad)
    with pytest.raises(ValueError, match="ivf_nprobe"):
        _faiss(ivf_nprobe=0)
    pe = DataMemoryElement(json.dumps(
        {"factory_string": "IVF1024,PQ64"}).encode())
    with caplog.at_level(logging.WARNING):
        _faiss(index_param_element=pe, factory_string="Flat")
    assert any("factory_string" in r.message for r in caplog.records)
    report = FaissNearestNeighborsIndex.usability_report()
    assert report["kernel_tier"] in ("cuda", "cpu-reference")


# ---------------------------------------------------------------------------
# the autotuned index
# ---------------------------------------------------------------------------

def _auto(**kw):
    return AutotunedNearestNeighborsIndex(device="cpu", **kw)


def _clustered(seed, n_centres=64, per=80):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_centres, 16)) * 10
    return [DescriptorMemoryElement(
        f"{c}-{j}", (centers[c] + rng.normal(size=16) * 0.3)
        .astype(np.float32)) for c in range(n_centres) for j in range(per)]


def test_autotune_config_and_validation(monkeypatch):
    assert AutotunedNearestNeighborsIndex \
        in NearestNeighborsIndex.get_impls()
    i = _auto(autotune=True, target_precision=0.9, sample_fraction=0.2,
              distance_method="hik", random_seed=3)
    for inst in configuration_test_helper(i):
        assert isinstance(inst, AutotunedNearestNeighborsIndex)
        assert (inst.autotune, inst.target_precision, inst.distance_method,
                inst.device) == (True, 0.9, "hik", "cpu")
    with pytest.raises(ValueError):
        _auto(distance_method="bogus")
    with pytest.raises(ValueError):
        _auto(target_precision=0.0)
    monkeypatch.setenv("SMQTK_TPU_NO_DMA_IVF", "1")
    report = AutotunedNearestNeighborsIndex.usability_report()
    assert report["disabled_flags"] == ["SMQTK_TPU_NO_DMA_IVF"]


@pytest.mark.parametrize("method,hist", [
    ("euclidean", False), ("hik", True), ("chi_square", True),
    ("cosine", False), ("inner_product", False)])
def test_autotune_exact_scans_equal_jax(method, hist):
    # Held-out queries: at a self-match the angular cosine distance
    # (arccos of a similarity rounded in f32) is noise of ~3e-4 in either
    # package, which no tolerance of the comparison should absorb.
    rng = np.random.default_rng(1)
    x = rng.random((70, 32)) if hist else rng.normal(size=(70, 32))
    if method == "hik":
        x /= x.sum(axis=1, keepdims=True)
    els = [DescriptorMemoryElement(j, v.astype(np.float32))
           for j, v in enumerate(x)]
    els, queries = els[:64], els[64:]
    port = _auto(distance_method=method)
    port.build_index(els)
    ref = jax_autotune.AutotunedNearestNeighborsIndex(distance_method=method)
    ref.build_index(elements_for(ref, els))
    u_p, d_p = _answers(port, queries, 5)
    u_r, d_r = _answers(ref, queries, 5)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
    res, dists = port.nn(els[10], 5)
    assert res[0] is els[10]
    if method not in ("cosine", "inner_product"):
        assert dists[0] == pytest.approx(0.0, abs=1e-5)
    assert list(dists) == sorted(dists)


def test_autotune_small_data_stays_exact():
    rng = np.random.default_rng(3)
    elems = [DescriptorMemoryElement(j, rng.normal(size=8)
                                     .astype(np.float32)) for j in range(64)]
    i = _auto(autotune=True, target_precision=0.5, random_seed=0)
    i.build_index(elems)
    assert i._ivf is None
    assert i.nn(elems[0], 1)[0][0].uuid() == 0


def test_autotune_calibrates_then_retunes_after_mutation():
    elems = _clustered(4)
    i = _auto(autotune=True, target_precision=0.9, sample_fraction=0.05,
              random_seed=0)
    i.build_index(elems)
    assert i._ivf is not None and i._tuned_nprobe is not None
    assert i._ivf.nprobe == i._tuned_nprobe and i._ivf.device == "cpu"
    res, dists = i.nn(elems[0], 5)
    assert res[0] is elems[0]
    assert dists[0] == pytest.approx(0.0, abs=1e-4)
    # Removing most of the data drops below the IVF threshold: exact scans.
    i.remove_from_index([e.uuid() for e in elems[640:]])
    assert i.count() == 640 and i._ivf is None
    assert i.nn(elems[0], 1)[0][0].uuid() == elems[0].uuid()


def test_autotune_update_remove_and_persistence():
    rng = np.random.default_rng(5)
    elems = [DescriptorMemoryElement(j, rng.normal(size=8)
                                     .astype(np.float32)) for j in range(32)]
    cache = DataMemoryElement()
    i = _auto(index_element=cache)
    i.build_index(elems[:16])
    with pytest.warns(UserWarning, match="Skipped 1"):
        i.update_index(elems[15:])
    assert i.count() == 32
    i.remove_from_index([0, 1])
    assert i.count() == 30
    with pytest.raises(KeyError):
        i.remove_from_index([0])
    i2 = _auto(index_element=cache)
    assert i2.count() == 30
    assert i2.nn(elems[3], 1)[0][0].uuid() == 3


# ---------------------------------------------------------------------------
# registry, utils and the example
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bare,module", [
    ("MRPTNearestNeighborsIndex", "mrpt"),
    ("FaissNearestNeighborsIndex", "faiss_compat"),
    ("AutotunedNearestNeighborsIndex", "autotune")])
def test_bare_names_resolve_to_the_port(bare, module):
    impls = NearestNeighborsIndex.get_impls()
    inst = from_config_dict({"type": bare, bare: {"device": "cpu"}}, impls)
    assert type(inst).__module__ == \
        f"smqtk_indexing_tpu_torch.models.nn_index.{module}"
    assert type(inst).__name__ == bare


def test_metrics_copy_equals_jax():
    rng = np.random.default_rng(0)
    a, b = rng.random(16), rng.random((5, 16))
    for name in ("histogram_intersection_distance", "euclidean_distance"):
        for x, y in ((a, a[::-1].copy()), (a, b), (b, b[::-1].copy())):
            np.testing.assert_array_equal(getattr(metrics, name)(x, y),
                                          getattr(jax_metrics, name)(x, y))
    assert metrics.histogram_intersection_distance_fast(a, b[0]) == \
        jax_metrics.histogram_intersection_distance_fast(a, b[0])
    np.testing.assert_array_equal(metrics.cosine_similarity(a, b),
                                  jax_metrics.cosine_similarity(a, b))
    np.testing.assert_array_equal(metrics.cosine_distance(a, b, False),
                                  jax_metrics.cosine_distance(a, b, False))
    assert metrics.hamming_distance(1 << 200, 5) == 3


def test_parallel_map_and_progress_reporter():
    assert list(parallel_map(lambda x, y: x * y, range(50), range(50),
                             cores=4)) == [i * i for i in range(50)]
    assert sorted(parallel_map(abs, [-3, 1, -2], ordered=False)) == [1, 2, 3]
    with pytest.warns(UserWarning, match="runs threads"):
        assert list(parallel_map(len, ["ab"], use_multiprocessing=True)) \
            == [2]
    lines = []
    rep = ProgressReporter(lambda m: lines.append(m), interval=0.0,
                           what_per_second="Rows")
    with pytest.raises(RuntimeError):
        rep.increment_report()
    rep.start()
    for _ in range(3):
        rep.increment_report_threadsafe()
    rep.report()
    assert len(lines) >= 2 and lines[-1].startswith("Rows per second")
    assert "3 total" in lines[-1]


def test_config_driven_example():
    from smqtk_indexing_tpu_torch.examples import config_driven
    top = config_driven.main("cpu")
    assert top[0] == (42, 0.0) and len(top) == 3
