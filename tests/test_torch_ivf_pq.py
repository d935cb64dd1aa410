"""
The port's ``IvfNearestNeighborsIndex`` with the PQ codecs ('pq<M>',
'opq<M>', ``pq_residual``) against the JAX package's, on the CPU.

- Code tier: the JAX index is built and its payload (centroids,
  assignments, codes, codebooks, OPQ rotation, residual flag) is loaded
  into the port, so both query the same trained state; payloads load in
  both directions.
- A code payload loaded by a rows instance decodes to float rows.
- The rows tier is ``tests/test_torch_ivf_pq_rows.py``.

The data is the clustered recipe of ``tests/test_torch_ivf.py``: d=96
(padded to 128), 6,000 rows over 2 tiles, 16 lists, 8 held-out queries.
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import ivf as jax_ivf
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index import ivf as port_ivf
from smqtk_indexing_tpu_torch.ops import ivf_scan
from tests.test_torch_helpers import assert_same_neighbours, elements_for
from tests.test_torch_ivf import ELEMS, K, LISTS, N, Q, _result

torch.set_num_threads(1)

#: Distances, port vs JAX, where both re-rank exactly from the same
#: reconstructions in different summation orders.
EXACT_TOL = (1e-5, 1e-5)
#: Score mode, on the squared distance: the JAX CPU run goes through the
#: TPU kernel's split-bf16 table, ~2^-16 of ||q||^2 + s2 + 2 sum |LUT|
#: (about 100 here), with a 4x margin.
SCORE_ATOL = 4.0 * 2.0 ** -16 * 100.0


def _kw(storage, dtype, metric, rerank, residual, nprobe=4):
    return dict(n_lists=LISTS, nprobe=nprobe, random_seed=0, metric=metric,
                dtype=dtype, storage=storage, rerank=rerank,
                pq_residual=residual)


def _squared(d, metric):
    """Score-mode distances on the scale the kernel sums them."""
    if metric == "euclidean":
        return d ** 2
    if metric == "cosine":
        return 2.0 * (1.0 - np.cos(d * np.pi / 2.0))
    return d


CODE_CELLS = [(dtype, metric, residual)
              for dtype in ("pq16", "opq16")
              for metric in ("euclidean", "inner_product", "cosine")
              for residual in (False, True)
              if not (residual and metric == "inner_product")]


@pytest.mark.parametrize("dtype,metric,residual", CODE_CELLS)
def test_code_tier_matches_jax(dtype, metric, residual):
    kw = _kw("code", dtype, metric, "exact", residual)
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(index_element=elem, **kw)
    # OPQ trains its rotation on every row: one tile of rows keeps the
    # JAX package's training short.
    ref.build_index(elements_for(
        ref, ELEMS if dtype == "pq16" else ELEMS[:N // 2]))
    port = port_ivf.IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cpu",
        **kw)
    # The same codes, tiles and float64 host stats in both packages.
    np.testing.assert_array_equal(port._host, ref._host)
    assert port._host.dtype == np.uint8
    np.testing.assert_array_equal(port._dev3.numpy(),
                                  np.asarray(ref._dev3).view(np.uint8))
    np.testing.assert_array_equal(port._s2t.numpy(), np.asarray(ref._s2t))
    assert (port._code_rot is not None) == (dtype == "opq16")
    assert port.pq_residual == residual
    before = ivf_scan.LAUNCHES["ivf_list_scores_tiled_pq"]
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
    # Score mode on the same state: the kernel's surrogate.
    port.rerank = ref.rerank = "score"
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, _squared(d_p, metric), u_r,
                           _squared(d_r, metric), rtol=0.0,
                           atol=SCORE_ATOL)
    # On the CPU the wrapper takes the plain version: no kernel launch.
    assert ivf_scan.LAUNCHES["ivf_list_scores_tiled_pq"] == before


@pytest.mark.parametrize("dtype,metric,residual", [
    ("opq16", "euclidean", True), ("pq12", "cosine", False)])
def test_port_payload_loads_in_jax(dtype, metric, residual):
    kw = _kw("code", dtype, metric, "exact", residual)
    elem = DataMemoryElement()
    port = port_ivf.IvfNearestNeighborsIndex(index_element=elem,
                                             device="cpu", **kw)
    port.build_index(ELEMS[:N // 2])
    port.remove_from_index([3, 4, 5])
    ref = jax_ivf.IvfNearestNeighborsIndex(
        index_element=JaxDataMemoryElement(elem.get_bytes()), **kw)
    assert ref.count() == port.count() == N // 2 - 3
    np.testing.assert_array_equal(np.asarray(ref._code_cb), port._code_cb)
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)


def _decoded(index):
    return np.stack([index._row_vector(i)
                     for i in range(index._host.shape[0])])


def test_exhaustive_probe_is_exact_wrt_reconstruction():
    # Every list probed: the float64 top-k over the index's own
    # reconstructions (tests/ops/test_pallas_ivf_pq_tiled.py:67-85).
    port = port_ivf.IvfNearestNeighborsIndex(
        device="cpu", **_kw("code", "opq16", "euclidean", "exact", True,
                            nprobe=LISTS))
    port.build_index(ELEMS[:N // 2])
    u_p, d_p = _result(port)
    x64 = _decoded(port).astype(np.float64)
    uids = np.array(port._row2uid)
    dist = np.sqrt(((Q[:, None, :].astype(np.float64) - x64[None]) ** 2)
                   .sum(-1))
    order = np.argsort(dist, axis=1, kind="stable")[:, :K]
    assert_same_neighbours(u_p, d_p, uids[order],
                           np.take_along_axis(dist, order, 1), 1e-5, 1e-5)


@pytest.mark.parametrize("dtype,residual", [("pq16", False),
                                            ("opq16", True)])
def test_pq_payload_loaded_by_rows_instance_decodes_to_float(dtype,
                                                             residual):
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(
        index_element=elem, **_kw("code", dtype, "euclidean", "exact",
                                  residual))
    ref.build_index(elements_for(ref, ELEMS[:3000]))
    kw = _kw("rows", "float32", "euclidean", "exact", False)
    port = port_ivf.IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cpu",
        **kw)
    jax_rows = jax_ivf.IvfNearestNeighborsIndex(
        index_element=JaxDataMemoryElement(elem.get_bytes()), **kw)
    assert port._host.dtype == np.float32 and port._host.shape[1] == 96
    np.testing.assert_allclose(port._host, np.asarray(jax_rows._host),
                               rtol=1e-5, atol=1e-5)
    # The float rows are the code tier's own reconstructions.
    np.testing.assert_allclose(port._host, _decoded(ref), rtol=1e-5,
                               atol=1e-5)
    u_p, d_p = _result(port)
    u_r, d_r = _result(jax_rows)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
