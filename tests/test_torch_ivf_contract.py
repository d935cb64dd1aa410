"""
The port's ``IvfNearestNeighborsIndex`` contract on the CPU: the
configuration matrix (the cells of
``tests/impls/nn_index/test_ivf_combinations.py`` without sharding),
the interface's contract probes, mutation (update, removal, compaction,
the code tier's in-place removal poison) against the JAX index from the
same payload, the configuration round trip and the fully-qualified key.
"""
import itertools
import json
import warnings

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import ivf as jax_ivf
from smqtk_indexing_tpu_torch.core.configuration import (
    configuration_test_helper, from_config_dict,
)
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import (
    DescriptorMemoryElement, MemoryDescriptorSet,
)
from smqtk_indexing_tpu_torch.data.exceptions import ReadOnlyError
from smqtk_indexing_tpu_torch.interfaces.nearest_neighbor_index import (
    NearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.models.nn_index import ivf as port_ivf
from smqtk_indexing_tpu_torch.models.nn_index._ivf_matrix import (
    validate_ivf_combination,
)
from smqtk_indexing_tpu_torch.ops.ivf_scan import TILE_ROWS
from tests.test_torch_helpers import assert_same_neighbours, elements_for

torch.set_num_threads(1)

PORT_KEY = ("smqtk_indexing_tpu_torch.models.nn_index.ivf."
            "IvfNearestNeighborsIndex")
JAX_KEY = "smqtk_indexing_tpu.models.nn_index.ivf.IvfNearestNeighborsIndex"
METRICS = ("euclidean", "inner_product", "cosine")
DTYPES = ("float32", "bfloat16", "sq8", "pq4", "opq4")


def _index(**kw):
    return port_ivf.IvfNearestNeighborsIndex(device="cpu", **kw)


def _jax_ok(metric, dtype, storage, residual):
    """The JAX package's matrix (test_ivf_combinations._expected_ok)."""
    is_pq = dtype in ("pq4", "opq4")
    if residual and (not is_pq or metric == "inner_product"
                     or (metric == "cosine" and storage != "code")):
        return False
    return not (storage == "code" and dtype in ("float32", "bfloat16"))


@pytest.mark.parametrize(
    "metric,dtype,storage,rerank,n_devices,residual",
    list(itertools.product(METRICS, DTYPES, ("rows", "code"),
                           ("exact", "score"), (None, 8), (False, True))))
def test_matrix_cell_validation(metric, dtype, storage, rerank, n_devices,
                                residual):
    # The JAX cells, on one device and sharded alike.
    if _jax_ok(metric, dtype, storage, residual):
        validate_ivf_combination(metric, dtype, storage, rerank, n_devices,
                                 residual)
        return
    with pytest.raises(ValueError):
        validate_ivf_combination(metric, dtype, storage, rerank, n_devices,
                                 residual)


@pytest.mark.parametrize("bad_kw", [dict(metric="hamming"),
                                    dict(dtype="pq4x12"),
                                    dict(storage="tiles"),
                                    dict(rerank="none")])
def test_unknown_values_rejected(bad_kw):
    with pytest.raises(ValueError):
        _index(**bad_kw)


def _corpus():
    rng = np.random.default_rng(42)
    vecs = rng.normal(size=(400, 24)).astype(np.float32)
    return [DescriptorMemoryElement(i, v) for i, v in enumerate(vecs)]


CORPUS = _corpus()

BUILD_CELLS = (
    [("rows", dt, m, "exact") for dt in ("float32", "bfloat16", "sq8")
     for m in METRICS]
    + [("code", "sq8", "euclidean", "exact")]
    + [("code", "sq8", m, rr) for m in ("inner_product", "cosine")
       for rr in ("exact", "score")]
    + [("code", "sq8", "euclidean", "score"),
       ("rows", "sq8", "euclidean", "score")]
)
#: The PQ cells of test_ivf_combinations.BUILD_CELLS, single device:
#: (storage, dtype, metric, rerank, pq_residual).
PQ_BUILD_CELLS = (
    [("rows", dt, m, "exact", False) for dt in ("pq4", "opq4")
     for m in METRICS]
    + [("code", dt, "euclidean", "exact", False) for dt in ("pq4", "opq4")]
    + [("code", "pq4", m, rr, False) for m in ("inner_product", "cosine")
       for rr in ("exact", "score")]
    + [("rows", "pq4", "euclidean", "exact", True),
       ("code", "pq4", "euclidean", "exact", True)]
    + [("code", "pq4", "cosine", rr, True) for rr in ("exact", "score")]
    + [("code", "opq4", "cosine", "exact", True)]
)


@pytest.mark.parametrize(
    "storage,dtype,metric,rerank,residual",
    [c + (False,) for c in BUILD_CELLS] + PQ_BUILD_CELLS)
def test_supported_cell_builds_and_queries(storage, dtype, metric, rerank,
                                           residual):
    idx = _index(descriptor_set=MemoryDescriptorSet(), n_lists=4, nprobe=4,
                 metric=metric, dtype=dtype, storage=storage, rerank=rerank,
                 pq_residual=residual, random_seed=0)
    idx.build_index(CORPUS)
    neighbours, dists = idx.nn(CORPUS[17], 5)
    got = [e.uuid() for e in neighbours]
    assert len(got) == 5 and 17 in got, got
    assert list(dists) == sorted(dists)
    if dtype in ("float32", "bfloat16"):
        assert got[0] == 17


def _clustered(n, seed=0):
    rng = np.random.default_rng(seed)
    centres = rng.random((32, 96), dtype=np.float32)
    x = centres[rng.integers(0, 32, size=n)] \
        + rng.normal(size=(n, 96)).astype(np.float32) / 12
    return [DescriptorMemoryElement(i, v.astype(np.float32))
            for i, v in enumerate(x)]


MUT = _clustered(5000)
MUT_Q = _clustered(8, seed=1)


def _both(storage, dtype, rerank, metric="euclidean", residual=False):
    kw = dict(n_lists=16, nprobe=4, random_seed=0, storage=storage,
              dtype=dtype, rerank=rerank, metric=metric,
              pq_residual=residual)
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(index_element=elem, **kw)
    ref.build_index(elements_for(ref, MUT[:4000]))
    port = port_ivf.IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cpu",
        **kw)
    return ref, port


def _same_results(port, ref, atol):
    out = []
    for index in (port, ref):
        res = index.nn_many(elements_for(index, MUT_Q), 10)
        out.append((np.array([[e.uuid() for e in r[0]] for r in res]),
                    np.array([r[1] for r in res])))
    assert_same_neighbours(out[0][0], out[0][1], out[1][0], out[1][1],
                           rtol=0.0 if atol else 1e-5, atol=atol or 1e-5)
    return out[0][0]


@pytest.mark.parametrize("storage,dtype,rerank,residual", [
    ("code", "sq8", "exact", False), ("code", "sq8", "score", False),
    ("rows", "float32", "exact", False), ("code", "pq16", "exact", False),
    ("code", "opq16", "score", True)])
def test_update_remove_and_compaction_match_jax(storage, dtype, rerank,
                                                residual):
    # PQ cells: updates encode with the build-time codebooks (and OPQ
    # rotation and list residuals), and compaction keeps them.
    ref, port = _both(storage, dtype, rerank, residual=residual)
    codec = None if port._code_cb is None else port._code_cb.copy()
    atol = 5e-3 if rerank == "score" else None
    for index in (ref, port):
        index.update_index(elements_for(index, MUT[3900:]))  # 100 old
    assert port.count() == ref.count() == 5000
    _same_results(port, ref, atol)
    removed = list(range(0, 5000, 3))
    for index in (ref, port):
        index.remove_from_index(removed)         # in place: 2/3 stay live
    if storage == "code":
        # Removal poisons the removed rows' stats in place, with no
        # rebuild; those rows can never win.
        rows = [port._row2uid.index(u) for u in removed[:50]]
        s2 = port._s2t.numpy().reshape(-1)
        assert np.isinf(s2[rows]).all()
        assert port._s2t.shape[0] * TILE_ROWS >= port._host.shape[0]
    got = _same_results(port, ref, atol)
    assert not set(got.ravel().tolist()) & set(removed)
    more = list(range(1, 5000, 3))
    for index in (ref, port):
        index.remove_from_index(more)            # under half: compaction
    assert port._host.shape[0] == port.count() == ref.count()
    got = _same_results(port, ref, atol)
    assert not set(got.ravel().tolist()) & (set(removed) | set(more))
    if codec is not None:
        np.testing.assert_array_equal(port._code_cb, codec)
        np.testing.assert_array_equal(port._host, ref._host)


def test_contract_probes():
    idx = _index(n_lists=4, nprobe=4, random_seed=0)
    with pytest.raises(ValueError):
        idx.build_index([])
    with pytest.raises(ValueError):
        idx.nn(CORPUS[0], 1)
    idx.build_index(CORPUS[:10])
    with pytest.raises(KeyError):
        idx.remove_from_index([3, "unknown"])
    assert idx.count() == 10
    with pytest.raises(ValueError):
        idx.nn(DescriptorMemoryElement("empty"), 1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        neighbours, dists = idx.nn(CORPUS[0], 25)
    assert len(neighbours) == len(dists) == 10
    assert any("only 10" in str(w.message) for w in caught)
    ro = _index(read_only=True)
    for call in (lambda: ro.build_index(CORPUS[:3]),
                 lambda: ro.update_index(CORPUS[:3]),
                 lambda: ro.remove_from_index([0])):
        with pytest.raises(ReadOnlyError):
            call()


def test_removing_everything_then_updating_rebuilds():
    idx = _index(n_lists=4, nprobe=4, random_seed=0, storage="code",
                 dtype="sq8")
    idx.build_index(CORPUS[:50])
    idx.remove_from_index([e.uuid() for e in CORPUS[:50]])
    assert idx.count() == 0
    with pytest.raises(ValueError):
        idx.nn(CORPUS[0], 1)
    idx.update_index(CORPUS[50:80])
    assert idx.count() == 30
    assert idx.nn(CORPUS[60], 1)[0][0].uuid() == 60


def test_nprobe_is_a_query_time_knob():
    idx = _index(n_lists=16, nprobe=1, random_seed=0)
    idx.build_index(MUT[:2000])
    narrow = idx.nn_many(MUT_Q, 10)
    idx.nprobe = 16
    wide = idx.nn_many(MUT_Q, 10)
    for n_res, w_res in zip(narrow, wide):
        assert w_res[1][-1] <= n_res[1][-1] + 1e-6


def test_configuration_round_trip():
    inst = _index(metric="cosine", n_lists=32, nprobe=3, dtype="sq8",
                  storage="code", rerank="score", random_seed=5,
                  read_only=True)
    for i in configuration_test_helper(inst):
        assert isinstance(i, port_ivf.IvfNearestNeighborsIndex)
        assert (i.metric, i.n_lists, i.nprobe, i.dtype, i.storage,
                i.rerank, i.random_seed, i.read_only, i.device) == \
            ("cosine", 32, 3, "sq8", "code", "score", 5, True, "cpu")
    json.dumps(port_ivf.IvfNearestNeighborsIndex.get_default_config())


def test_fully_qualified_key_selects_the_port():
    # The port's registry holds its own class and not the JAX package's,
    # though both are imported here: the qualified key and the bare name
    # select the port, and the JAX package's key matches nothing.
    impls = NearestNeighborsIndex.get_impls()
    assert port_ivf.IvfNearestNeighborsIndex in impls
    assert jax_ivf.IvfNearestNeighborsIndex not in impls
    for key in (PORT_KEY, "IvfNearestNeighborsIndex"):
        inst = from_config_dict(
            {"type": key, key: {"device": "cpu", "n_lists": 8}}, impls)
        assert type(inst) is port_ivf.IvfNearestNeighborsIndex
        assert inst.n_lists == 8
    with pytest.raises(ValueError, match="does not match"):
        from_config_dict({"type": JAX_KEY}, impls)


def test_pq_payload_raises_until_the_codec_slice():
    # The codec slice is ported: a JAX PQ code-tier payload loaded by an
    # SQ8 code-tier instance decodes to float rows, which the SQ8 codec
    # then encodes (the JAX package does the same).
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(
        index_element=elem, n_lists=4, nprobe=4, random_seed=0,
        dtype="pq4", storage="code")
    ref.build_index(elements_for(ref, CORPUS[:300]))
    kw = dict(n_lists=4, nprobe=4, dtype="sq8", storage="code")
    port = _index(index_element=DataMemoryElement(elem.get_bytes()), **kw)
    jax_sq8 = jax_ivf.IvfNearestNeighborsIndex(
        index_element=JaxDataMemoryElement(elem.get_bytes()), **kw)
    assert port.count() == jax_sq8.count() == 300
    assert port._host.dtype == np.int8
    np.testing.assert_array_equal(port._host, jax_sq8._host)
    np.testing.assert_allclose(port._code_a, jax_sq8._code_a, rtol=1e-6)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        port_ivf.IvfNearestNeighborsIndex()
    report = port_ivf.IvfNearestNeighborsIndex.usability_report()
    assert report["usable"] is True
    assert report["kernel_tier"] == "cpu-reference"
