"""
The port's ``IvfNearestNeighborsIndex`` rows tier with the PQ codecs
('pq<M>', 'opq<M>', ``pq_residual``) against the JAX package's, on the
CPU. The rows tier retrains its codec per layout and never persists it,
so the port's trainers are monkeypatched to return the codebooks (and
rotation) the JAX index trained on the same rows. The port routes
euclidean to the tiled engine (K8's plain version here), as the JAX
package does on a TPU; on the CPU the JAX index takes its row-major list
scan. Data: ``tests/test_torch_ivf.py``'s.
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import ivf as jax_ivf
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index import _ivf_rows
from smqtk_indexing_tpu_torch.models.nn_index import ivf as port_ivf
from smqtk_indexing_tpu_torch.ops import opq, pq
from tests.test_torch_helpers import assert_same_neighbours, elements_for
from tests.test_torch_ivf import ELEMS, N, _result
from tests.test_torch_ivf_pq import EXACT_TOL, _kw

torch.set_num_threads(1)


ROWS_CELLS = [("pq16", "euclidean", False), ("opq16", "euclidean", False),
              ("pq16", "euclidean", True), ("opq16", "euclidean", True),
              ("pq16", "cosine", False), ("opq16", "inner_product", False)]


@pytest.mark.parametrize("dtype,metric,residual", ROWS_CELLS)
def test_rows_tier_matches_jax(monkeypatch, dtype, metric, residual):
    kw = _kw("rows", dtype, metric, "exact", residual)
    elem = JaxDataMemoryElement()
    ref = jax_ivf.IvfNearestNeighborsIndex(index_element=elem, **kw)
    ref.build_index(elements_for(ref, ELEMS))
    cb = np.asarray(ref._pq_cb_dev)
    rot = ref._pq_rot
    seen = []

    def pq_trained(live, m, **_):
        seen.append(live)
        return cb

    def opq_trained(live, m, **_):
        seen.append(live)
        return rot, cb
    # The routed (tiled) build and the row-major store build both train
    # through these names.
    for mod, name, fn in ((_ivf_rows, "pq_train", pq_trained),
                          (_ivf_rows, "opq_train", opq_trained),
                          (pq, "pq_train", pq_trained),
                          (opq, "opq_train", opq_trained)):
        monkeypatch.setattr(mod, name, fn)
    port = port_ivf.IvfNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), device="cpu",
        **kw)
    assert len(seen) == 1 and seen[0].shape == (N, 128)
    # Euclidean takes the tiled engine (K8), the rest the list gather.
    assert (port._dev3 is not None) == (metric == "euclidean")
    assert ref._dev3 is None
    u_p, d_p = _result(port)
    u_r, d_r = _result(ref)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *EXACT_TOL)
