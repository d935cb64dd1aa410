"""
The JAX package's kernel opt-outs in the port, on the CPU:
``SMQTK_TPU_NO_FUSED`` (the flat store), ``SMQTK_TPU_NO_DMA_IVF``,
``SMQTK_TPU_NO_ROWS_TILED`` and ``SMQTK_TPU_ROWS_TILED`` (the IVF rows
tier). Each switch, set with ``monkeypatch.setenv``, sends the query to the
plain route (the kernel wrappers are never called, so no kernel can
launch), is listed in ``usability_report()["disabled_flags"]`` with
``degraded`` true, and leaves the results equal to the JAX index's on the
same payload. The routing precedence is held against the JAX
``_tiled_rows_ok`` on the same configurations, with the JAX package's
``tpu_kernel_enabled`` answering as on a TPU (the port routes as the JAX
package does there, on every device). The kernels' launch counts are held
on the card (``tests/test_torch_cuda.py``).
"""
import os

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import flat as jax_flat
from smqtk_indexing_tpu.models.nn_index import ivf as jax_ivf
from smqtk_indexing_tpu.ops import device as jax_device
from smqtk_indexing_tpu.ops.store import VectorStore as JaxVectorStore
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index import _ivf_rows
from smqtk_indexing_tpu_torch.models.nn_index import flat as port_flat
from smqtk_indexing_tpu_torch.models.nn_index import ivf as port_ivf
from smqtk_indexing_tpu_torch.ops import (
    device, fused_scan, ivf_scan, opq, pq, scan, store,
)
from smqtk_indexing_tpu_torch.ops.store import VectorStore
from tests.test_torch_helpers import assert_same_neighbours, elements_for
from tests.test_torch_ivf import ELEMS, EXACT_TOL, _kw, _result

torch.set_num_threads(1)

SWITCHES = ("SMQTK_TPU_NO_FUSED", "SMQTK_TPU_NO_DMA_IVF",
            "SMQTK_TPU_NO_ROWS_TILED", "SMQTK_TPU_ROWS_TILED",
            "SMQTK_TPU_NO_NATIVE")
#: Each index's listed switches: the JAX indexes' tuples.
REPORTED = {port_flat.FlatNearestNeighborsIndex:
            ("SMQTK_TPU_NO_FUSED", "SMQTK_TPU_NO_NATIVE"),
            port_ivf.IvfNearestNeighborsIndex:
            ("SMQTK_TPU_NO_DMA_IVF", "SMQTK_TPU_NO_ROWS_TILED")}
#: The kernel wrappers: K1 in fused_scan; K6, K7, K8 in ivf_scan.
KERNELS = ((fused_scan, "segment_minima"),
           (ivf_scan, "ivf_list_scores"),
           (ivf_scan, "ivf_list_scores_tiled"),
           (ivf_scan, "ivf_list_scores_tiled_pq"))


@pytest.fixture(autouse=True)
def no_switches(monkeypatch):
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)


@pytest.fixture
def calls(monkeypatch):
    """Counts the calls of each kernel wrapper by name (the CPU runs its
    plain version inside the wrapper, the card its kernel)."""
    seen = {name: 0 for _, name in KERNELS}
    for mod, name in KERNELS:
        real = getattr(mod, name)

        def spy(*args, _real=real, _name=name, **kwargs):
            seen[_name] += 1
            return _real(*args, **kwargs)
        monkeypatch.setattr(mod, name, spy)
    return seen


def test_tpu_kernel_enabled_reads_the_switch_per_call(monkeypatch):
    assert device.tpu_kernel_enabled("SMQTK_TPU_NO_FUSED")
    monkeypatch.setenv("SMQTK_TPU_NO_FUSED", "1")
    assert not device.tpu_kernel_enabled("SMQTK_TPU_NO_FUSED")
    assert device.tpu_kernel_enabled("SMQTK_TPU_NO_DMA_IVF")
    monkeypatch.delenv("SMQTK_TPU_NO_FUSED")
    assert device.tpu_kernel_enabled("SMQTK_TPU_NO_FUSED")


@pytest.mark.parametrize("cls", list(REPORTED), ids=lambda c: c.__module__
                         .rsplit(".", 1)[1])
@pytest.mark.parametrize("switch", SWITCHES)
def test_usability_report_lists_the_switch(monkeypatch, cls, switch):
    monkeypatch.setenv(switch, "1")
    report = cls.usability_report()
    listed = switch in REPORTED[cls]
    assert report["disabled_flags"] == ([switch] if listed else [])
    if listed:
        assert report["degraded"]
    # The JAX index lists the same switches.
    jax_cls = {port_flat.FlatNearestNeighborsIndex:
               jax_flat.FlatNearestNeighborsIndex,
               port_ivf.IvfNearestNeighborsIndex:
               jax_ivf.IvfNearestNeighborsIndex}[cls]
    assert jax_cls.usability_report()["disabled_flags"] \
        == report["disabled_flags"]


def _flat_case():
    rng = np.random.default_rng(7)
    return (rng.random((3000, 40), dtype=np.float32),
            rng.random((6, 40), dtype=np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_no_fused_sends_the_flat_store_to_the_plain_scan(monkeypatch, calls,
                                                         dtype):
    x, q = _flat_case()
    routed = []
    real = store.scan.flat_topk

    def spy(*args, **kwargs):
        routed.append(kwargs["metric"])
        return real(*args, **kwargs)
    monkeypatch.setattr(scan, "flat_topk", spy)
    port = VectorStore(dtype, device="cpu")
    ref = JaxVectorStore(dtype)
    for s in (port, ref):
        s.build(x, list(range(len(x))))
        s.remove(list(range(0, len(x), 13)))
    port.knn(q, 8, "euclidean")
    assert calls["segment_minima"] == 1 and routed == []
    monkeypatch.setenv("SMQTK_TPU_NO_FUSED", "1")
    assert not port._fused_eligible("euclidean")
    for metric in ("euclidean", "inner_product", "cosine"):
        d_p, u_p, _ = port.knn(q, 8, metric)
        d_j, u_j, _ = ref.knn(q, 8, metric)
        tol = (1e-5, 1e-6) if dtype == "float32" else (1e-2, 1e-2)
        assert_same_neighbours(np.array(u_p), d_p, np.array(u_j), d_j, *tol)
    assert calls["segment_minima"] == 1
    assert routed == ["euclidean", "inner_product", "cosine"]
    # Read per query: unset, K1 serves the next query.
    monkeypatch.delenv("SMQTK_TPU_NO_FUSED")
    port.knn(q, 8, "euclidean")
    assert calls["segment_minima"] == 2


def test_no_fused_takes_k1_out_of_the_sq8_store(monkeypatch, calls):
    # 70,000 rows: capacity 131,072, where the sq8 store's stage 1 is K1's
    # int8 form (store.py:89-103).
    rng = np.random.default_rng(8)
    x = rng.random((70000, 24), dtype=np.float32)
    q = rng.random((6, 24), dtype=np.float32)
    fused = []
    real = store.sq8_topk

    def spy(*args, **kwargs):
        fused.append(kwargs["fused"])
        return real(*args, **kwargs)
    monkeypatch.setattr(store, "sq8_topk", spy)
    port = VectorStore("sq8", device="cpu")
    ref = JaxVectorStore("sq8")
    for s in (port, ref):
        s.build(x, list(range(70000)))
    assert port._sq8_fused_eligible("euclidean")
    monkeypatch.setenv("SMQTK_TPU_NO_FUSED", "1")
    # The int8 x int8 switch needs the fused stage 1, so it changes nothing.
    monkeypatch.setenv("SMQTK_TPU_SQ8_I8DOT", "1")
    for metric in ("euclidean", "inner_product"):
        d_p, u_p, _ = port.knn(q, 8, metric)
        d_j, u_j, _ = ref.knn(q, 8, metric)
        assert_same_neighbours(np.array(u_p), d_p, np.array(u_j), d_j,
                               1e-5, 1e-5)
    assert fused == [False, False] and calls["segment_minima"] == 0


#: Index configurations whose rows-tier routing the switches decide:
#: (storage, dtype, metric, rerank).
ROUTING_CELLS = [("rows", "sq8", "euclidean", "score"),
                 ("rows", "sq8", "euclidean", "exact"),
                 ("rows", "pq16", "euclidean", "exact"),
                 ("rows", "opq16", "euclidean", "score"),
                 ("rows", "float32", "euclidean", "exact"),
                 ("rows", "pq16", "cosine", "exact"),
                 ("code", "sq8", "euclidean", "score")]
ROUTING_ENVS = [(), ("SMQTK_TPU_NO_ROWS_TILED",), ("SMQTK_TPU_ROWS_TILED",),
                ("SMQTK_TPU_NO_ROWS_TILED", "SMQTK_TPU_ROWS_TILED"),
                ("SMQTK_TPU_NO_DMA_IVF",),
                ("SMQTK_TPU_ROWS_TILED", "SMQTK_TPU_NO_DMA_IVF")]


@pytest.mark.parametrize("env", ROUTING_ENVS, ids="+".join)
def test_rows_tiled_precedence_matches_jax(monkeypatch, env):
    # The JAX gate as on a TPU: only the switch can close it.
    monkeypatch.setattr(jax_device, "tpu_kernel_enabled",
                        lambda flag: not os.environ.get(flag))
    for name in env:
        monkeypatch.setenv(name, "1")
    for storage, dtype, metric, rerank in ROUTING_CELLS:
        kw = dict(storage=storage, dtype=dtype, metric=metric, rerank=rerank)
        port = port_ivf.IvfNearestNeighborsIndex(device="cpu", **kw)
        ref = jax_ivf.IvfNearestNeighborsIndex(**kw)
        assert port._tiled_rows_ok() == ref._tiled_rows_ok(), kw
    tiled = port_ivf.IvfNearestNeighborsIndex(
        device="cpu", storage="rows", dtype="sq8", rerank="exact")
    assert tiled._tiled_rows_ok() == (env == ("SMQTK_TPU_ROWS_TILED",)
                                      or env == ("SMQTK_TPU_ROWS_TILED",
                                                 "SMQTK_TPU_NO_DMA_IVF"))


def _jax_then_port(monkeypatch, storage, dtype, metric, rerank,
                   residual=False):
    """Build the JAX index under the current switches and load its
    payload into the port (whose rows tier lays out anew under the same
    switches); the port's PQ trainers return the JAX codebooks."""
    kw = _kw(storage, dtype, metric, rerank)
    if residual:
        kw["pq_residual"] = True
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(index_element=elem, **kw)
    ref.build_index(elements_for(ref, ELEMS))
    if pq.pq_m(dtype) is not None:
        cb = np.asarray(ref._pq_cb_dev)
        for mod, name, fn in (
                (_ivf_rows, "pq_train", lambda *a, **k: cb),
                (_ivf_rows, "opq_train", lambda *a, **k: (ref._pq_rot, cb)),
                (pq, "pq_train", lambda *a, **k: cb),
                (opq, "opq_train", lambda *a, **k: (ref._pq_rot, cb))):
            monkeypatch.setattr(mod, name, fn)
    port = port_ivf.IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cpu",
        **kw)
    return ref, port


@pytest.mark.parametrize("dtype,rerank", [("float32", "exact"),
                                          ("sq8", "score")])
def test_no_dma_ivf_takes_the_rows_tier_off_its_kernels(monkeypatch, calls,
                                                        dtype, rerank):
    monkeypatch.setenv("SMQTK_TPU_NO_DMA_IVF", "1")
    ref, port = _jax_then_port(monkeypatch, "rows", dtype, "euclidean",
                               rerank)
    # sq8 score mode loses the tiled routing, float32 K6.
    assert port._dev3 is None and not port._dma_eligible()
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
    assert calls == dict.fromkeys(calls, 0)
    # Read per query: unset, K6 serves the row-major layout again.
    monkeypatch.delenv("SMQTK_TPU_NO_DMA_IVF")
    assert port._dma_eligible()
    _result(port)
    assert calls["ivf_list_scores"] == 1


@pytest.mark.parametrize("switch", ["SMQTK_TPU_NO_DMA_IVF",
                                    "SMQTK_TPU_NO_ROWS_TILED"])
@pytest.mark.parametrize("dtype,residual", [("pq16", True),
                                            ("opq16", False)])
def test_switches_lay_rows_tier_pq_out_row_major(monkeypatch, calls, switch,
                                                 dtype, residual):
    monkeypatch.setenv(switch, "1")
    ref, port = _jax_then_port(monkeypatch, "rows", dtype, "euclidean",
                               "exact", residual)
    assert port._dev3 is None and ref._dev3 is None
    assert (port._row2list_dev is not None) == residual
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
    # No K8 (nor K6: PQ rows are never K6's) on the row-major layout.
    assert calls == dict.fromkeys(calls, 0)


def test_no_rows_tiled_gives_sq8_score_mode_k6(monkeypatch, calls):
    monkeypatch.setenv("SMQTK_TPU_NO_ROWS_TILED", "1")
    ref, port = _jax_then_port(monkeypatch, "rows", "sq8", "euclidean",
                               "score")
    assert port._dev3 is None and port._dma_eligible()
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
    assert calls["ivf_list_scores"] == 1
    assert calls["ivf_list_scores_tiled"] == 0


def test_rows_tiled_forces_sq8_exact_onto_the_tiled_engine(monkeypatch,
                                                           calls):
    # Both packages run the tiled engine (the JAX one in interpret mode)
    # and re-rank its winners exactly.
    monkeypatch.setenv("SMQTK_TPU_ROWS_TILED", "1")
    ref, port = _jax_then_port(monkeypatch, "rows", "sq8", "euclidean",
                               "exact")
    assert port._dev3 is not None and ref._dev3 is not None
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
    assert calls["ivf_list_scores_tiled"] == 1
    assert calls["ivf_list_scores"] == 0
