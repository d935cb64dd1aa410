"""
The flat store's compressed codecs in the port ('sq8', 'pq<M>', 'opq<M>':
``smqtk_indexing_tpu_torch/ops/sq8.py``, ``ops/store.py``,
``models/nn_index/flat.py``) against the JAX package and against float64
over the quantized rows, on the CPU. Inputs are numpy arrays made from a
seed. K1's int8 form (the SQ8 stage 1) runs its plain version here and is
held against ``pallas_scan.segment_minima`` in interpret mode.

PQ codebooks and OPQ rotations are training runs, not bit for bit across
packages, so the store tests monkeypatch the port's trainers to return
what the JAX store trained on the same rows; SQ8 trains in numpy and
needs no patch.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smqtk_indexing_tpu.data.data_element import (
    DataMemoryElement as JaxDataMemoryElement,
)
from smqtk_indexing_tpu.models.nn_index import flat as jax_flat
from smqtk_indexing_tpu.ops import pallas_scan as jax_scan
from smqtk_indexing_tpu.ops import sq8 as jsq8
from smqtk_indexing_tpu.ops.store import VectorStore as JaxVectorStore
from smqtk_indexing_tpu_torch.data.data_element import DataMemoryElement
from smqtk_indexing_tpu_torch.data.descriptor import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index import flat as port_flat
from smqtk_indexing_tpu_torch.ops import fused_scan, opq, pq, sq8
from smqtk_indexing_tpu_torch.ops.device import pad_rows_np
from smqtk_indexing_tpu_torch.ops.store import VectorStore
from tests.test_torch_helpers import assert_same_neighbours, elements_for

torch.set_num_threads(1)

METRICS = ("euclidean", "inner_product", "cosine", "hik")
#: Distances: exact f32 formulas over the same quantized rows, summed in
#: different orders.
TOL = (1e-5, 1e-5)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _dist64(x64, q64, metric):
    if metric == "euclidean":
        return np.sqrt(((q64[:, None] - x64[None]) ** 2).sum(-1))
    if metric == "inner_product":
        return -(q64 @ x64.T)
    if metric == "cosine":
        sim = (q64 @ x64.T) / np.linalg.norm(q64, axis=1)[:, None] \
            / np.linalg.norm(x64, axis=1)[None]
        return 2.0 * np.arccos(np.clip(sim, -1, 1)) / np.pi
    return 1.0 - np.minimum(q64[:, None], x64[None]).sum(-1)


def _oracle(x64, q64, valid, metric, k):
    """Float64 top-k (rows, dists) over the live quantized rows."""
    dist = _dist64(x64, q64, metric)
    dist[:, ~valid] = np.inf
    ids = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return ids, np.take_along_axis(dist, ids, 1)


# ---------------------------------------------------------------------------
# K1's int8 form: the plain version against Pallas interpret mode
# ---------------------------------------------------------------------------

def test_k1_int8_plain_version_matches_pallas():
    n, d, b = 8192, 128, 16
    rng = np.random.default_rng(0)
    codes = rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    a = (rng.random(d) * 0.02).astype(np.float32)
    s2 = ((codes.astype(np.float64) * a) ** 2).sum(1).astype(np.float32)
    pen = np.where(rng.random(n) < 0.02, np.inf, 0.0).astype(np.float32)
    pen[128:256] = np.inf
    t = (rng.normal(size=(b, d)) * a).astype(np.float32)
    ref = np.asarray(jax_scan.segment_minima(
        jnp.asarray(codes).T, jnp.asarray(s2)[None], jnp.asarray(pen)[None],
        jnp.asarray(t), interpret=True))
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(_t(codes), _t(s2), _t(pen),
                                    _t(t)).numpy()
    assert fused_scan.LAUNCHES == before
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    assert np.isinf(out[:, 1]).all()
    # Both round the query operand to bf16, so every product is exact in
    # f32: the two differ by summation order, within 1e-5 of the sum of
    # the absolute terms.
    t_bf = torch.from_numpy(t).to(torch.bfloat16).double().numpy()
    mag = s2.max() + 2.0 * (np.abs(t_bf) @ np.abs(codes.astype(np.float64)).T
                            ).max()
    fin = np.isfinite(ref)
    assert np.abs(out[fin] - ref[fin]).max() <= 1e-5 * mag
    # And against float64 on the same operands.
    exact = (s2.astype(np.float64)[None] - 2.0 * t_bf @ codes.T
             + pen[None]).reshape(b, -1, 128).min(-1)
    assert np.abs(out[fin] - exact[fin]).max() <= 1e-5 * mag


# ---------------------------------------------------------------------------
# sq8_topk: the streamed route and the K1-int8 route
# ---------------------------------------------------------------------------

def _sq8_inputs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = rng.random((n, d), dtype=np.float32)
    valid = rng.random(n) >= 0.05
    q = rng.random((6, d), dtype=np.float32)
    return x, valid, q


@pytest.mark.parametrize("metric,route", [
    (m, r) for m in METRICS for r in ("single", "streamed", "fused")
    # K1's int8 stage 1 serves euclidean and inner_product.
    if r != "fused" or m in ("euclidean", "inner_product")])
def test_sq8_topk_matches_float64_and_jax(metric, route):
    n, d, k = 8192, 40, 8
    x, valid, q = _sq8_inputs(n, d, seed=1)
    d_pad = 128
    a, b, codes, s2, nrm = sq8.sq8_build_store(x, valid, n, d_pad, d, "cpu")
    ja, jb, jcodes, js2, jnrm = jsq8.sq8_build_store(x, valid, n, d_pad, d)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=1e-5)
    q_pad = pad_rows_np(q, q.shape[0], d_pad)
    chunk = 65536 if route == "single" else 2048
    before = dict(fused_scan.LAUNCHES)
    d_p, r_p = sq8.sq8_topk(codes, a, b, s2, nrm, _t(valid), _t(q_pad), k=k,
                            metric=metric, chunk=chunk,
                            fused=route == "fused")
    assert fused_scan.LAUNCHES == before
    x64 = sq8.sq8_decode(codes, a, b).double().numpy()
    ids, dist = _oracle(x64, q_pad.astype(np.float64), valid, metric, k)
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), ids, dist, *TOL)
    # The JAX streamed scan ranks with bf16 products but re-ranks exactly
    # with a k + 8 margin: the same rows and distances.
    d_j, r_j = jsq8.sq8_topk(jcodes, ja, jb, js2, jnrm, jnp.asarray(valid),
                             jnp.asarray(q_pad), k=k, metric=metric,
                             chunk=chunk)
    assert_same_neighbours(r_p.numpy(), d_p.numpy(), np.asarray(r_j),
                           np.asarray(d_j), *TOL)


# ---------------------------------------------------------------------------
# VectorStore with sq8 / pq16 / opq16 against the JAX store
# ---------------------------------------------------------------------------

N, D = 2600, 40
_rng = np.random.default_rng(2)
X = _rng.random((N, D), dtype=np.float32)
Q = _rng.random((8, D), dtype=np.float32)


def _adopt_jax_codec(monkeypatch, jax_store):
    """The port's PQ / OPQ trainers return what the JAX store trained."""
    cb, rot = np.asarray(jax_store._pq_cb), jax_store._pq_rot
    monkeypatch.setattr(pq, "pq_train", lambda live, m, **_: cb)
    monkeypatch.setattr(opq, "opq_train", lambda live, m, **_: (rot, cb))


def _store_rows64(store):
    """(capacity, d') float64 quantized rows in the space the store
    scores, and the query transform to that space."""
    if store._dtype_name == "sq8":
        x = sq8.sq8_decode(store._dev, store._sq8_a, store._sq8_b)
        return x.double().numpy(), lambda q: pad_rows_np(q, q.shape[0], 128)
    perm, rot, cb = store._codec
    x = pq._dequant(store._dev, torch.tensor(cb)).double().numpy()
    return x, lambda q: pq.pq_prep_queries(
        pad_rows_np(q, q.shape[0], 128), perm, rot)


def _check_against_oracle(store, metric, k=8):
    d_p, u_p, r_p = store.knn(Q, k, metric)
    x64, prep = _store_rows64(store)
    valid = store._dev_valid.numpy()
    ids, dist = _oracle(x64, prep(Q).astype(np.float64), valid, metric, k)
    assert_same_neighbours(r_p, d_p, ids, dist, *TOL)
    return d_p, u_p, r_p


@pytest.mark.parametrize("dtype", ["sq8", "pq16", "opq16"])
def test_store_codec_flow_matches_jax_and_float64(monkeypatch, dtype):
    jax_store = JaxVectorStore(dtype)
    port = VectorStore(dtype, device="cpu")
    # The added rows reach past the build's range (SQ8 clips them) and
    # grow the capacity from 2048 to 4096 (a full re-upload).
    extra = X[2000:] * 1.5
    jax_store.build(X[:2000], list(range(2000)))
    if dtype != "sq8":
        _adopt_jax_codec(monkeypatch, jax_store)
    port.build(X[:2000], list(range(2000)))
    codec = [None if c is None else c.copy() for c in port._codec]
    for store in (jax_store, port):
        store.add(extra, list(range(2000, N)))
        store.remove(list(range(0, N, 5)))
    assert port.capacity == jax_store.capacity == 4096

    def same_codec():
        for kept, now in zip(codec, port._codec):
            if kept is not None:
                np.testing.assert_array_equal(now, kept)
    # Added rows encode with the build-time codec.
    same_codec()
    if dtype == "sq8":
        np.testing.assert_array_equal(port._dev.numpy(),
                                      np.asarray(jax_store._dev))
        assert (np.abs(port._dev.numpy()[2000:N]) == 127).any()
    else:
        np.testing.assert_array_equal(port._dev.numpy()[:N],
                                      np.asarray(jax_store._dev)[:N])
    for metric in METRICS:
        if dtype == "opq16" and metric == "hik":
            with pytest.raises(ValueError, match="OPQ"):
                port.knn(Q, 8, metric)
            continue
        d_p, u_p, _ = _check_against_oracle(port, metric)
        d_j, u_j, _ = jax_store.knn(Q, 8, metric)
        assert_same_neighbours(np.array(u_p), d_p, np.array(u_j), d_j, *TOL)
    # Compaction (under half live) re-uploads with the same codec.
    for store in (jax_store, port):
        store.remove([u for u in range(N) if u % 5 and u % 3])
    assert port._host.shape[0] == port.n_valid == jax_store.n_valid
    same_codec()
    d_p, u_p, _ = _check_against_oracle(port, "euclidean")
    d_j, u_j, _ = jax_store.knn(Q, 8, "euclidean")
    assert_same_neighbours(np.array(u_p), d_p, np.array(u_j), d_j, *TOL)


def test_store_rejects_unknown_codecs():
    for bad in ("sq4", "pq", "opqx"):
        with pytest.raises(ValueError):
            VectorStore(bad, device="cpu")


# ---------------------------------------------------------------------------
# FlatNearestNeighborsIndex with the codecs
# ---------------------------------------------------------------------------

def _elems(x, start=0):
    return [DescriptorMemoryElement(start + i, x[i]) for i in range(len(x))]


def _nn(index, q, k=8):
    res = index.nn_many(elements_for(index, _elems(q, start=10 ** 6)), k)
    return (np.array([[e.uuid() for e in r[0]] for r in res]),
            np.array([r[1] for r in res], dtype=np.float64))


@pytest.mark.parametrize("metric", ["euclidean", "inner_product"])
def test_flat_sq8_k1_route_matches_jax(metric):
    # 70,000 rows: capacity 131,072, past one streamed block and a
    # multiple of 4096, so the port's stage 1 is K1's int8 form (its plain
    # version here); the JAX CPU index streams.
    rng = np.random.default_rng(3)
    x = rng.random((70000, 24), dtype=np.float32)
    q = rng.random((6, 24), dtype=np.float32)
    els = _elems(x)
    port = port_flat.FlatNearestNeighborsIndex(dtype="sq8", metric=metric,
                                               device="cpu")
    ref = jax_flat.FlatNearestNeighborsIndex(dtype="sq8", metric=metric)
    for index in (port, ref):
        index.build_index(elements_for(index, els))
        index.remove_from_index(list(range(0, 70000, 11)))
    assert port._store._sq8_fused_eligible(metric)
    u_p, d_p = _nn(port, q)
    u_r, d_r = _nn(ref, q)
    assert_same_neighbours(u_p, d_p, u_r, d_r, *TOL)


@pytest.mark.parametrize("dtype", ["sq8", "pq16"])
def test_flat_payload_round_trip(dtype):
    # The payload holds the live float rows; a load retrains the codec on
    # them. Two port loads of one payload agree, and the loaded store is
    # exact over its own quantized rows. SQ8's numpy codec also loads
    # across packages in both directions.
    els = _elems(X)
    elem = DataMemoryElement()
    port = port_flat.FlatNearestNeighborsIndex(index_element=elem,
                                               dtype=dtype, device="cpu")
    port.build_index(els[:2000])
    port.update_index(els[2000:])
    port.remove_from_index(list(range(0, N, 4)))
    loads = [port_flat.FlatNearestNeighborsIndex(
        index_element=DataMemoryElement(elem.get_bytes()), dtype=dtype,
        device="cpu") for _ in range(2)]
    assert loads[0].count() == loads[1].count() == port.count()
    u_a, d_a = _nn(loads[0], Q)
    u_b, d_b = _nn(loads[1], Q)
    np.testing.assert_array_equal(u_a, u_b)
    np.testing.assert_array_equal(d_a, d_b)
    _check_against_oracle(loads[0]._store, "euclidean")
    if dtype != "sq8":
        return
    ref = jax_flat.FlatNearestNeighborsIndex(
        index_element=JaxDataMemoryElement(elem.get_bytes()), dtype=dtype)
    u_r, d_r = _nn(ref, Q)
    assert_same_neighbours(u_r, d_r, u_a, d_a, *TOL)
    jelem = JaxDataMemoryElement()
    jax_src = jax_flat.FlatNearestNeighborsIndex(index_element=jelem,
                                                 dtype=dtype)
    jax_src.build_index(elements_for(jax_src, els[:1500]))
    dst = port_flat.FlatNearestNeighborsIndex(
        index_element=DataMemoryElement(jelem.get_bytes()), dtype=dtype,
        device="cpu")
    u_d, d_d = _nn(dst, Q)
    u_s, d_s = _nn(jax_src, Q)
    assert_same_neighbours(u_d, d_d, u_s, d_s, *TOL)


def test_flat_codec_options():
    with pytest.raises(ValueError, match="hik"):
        port_flat.FlatNearestNeighborsIndex(dtype="opq16", metric="hik",
                                            device="cpu")
    inst = port_flat.FlatNearestNeighborsIndex(dtype="opq8", metric="cosine",
                                               device="cpu")
    cfg = inst.get_config()
    assert cfg["dtype"] == "opq8"
    back = port_flat.FlatNearestNeighborsIndex.from_config(cfg)
    assert (back.dtype, back.metric) == ("opq8", "cosine")
