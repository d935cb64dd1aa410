"""
The f32 stage 1's dot modes in the port (``SMQTK_TPU_STAGE1``:
``split3``, ``native``, ``highest``) against the JAX package's
(``ops/pallas_scan.py`` in interpret mode, ``ops/device.py``), on the
CPU, where the port runs the kernels' plain versions: the hi / lo split,
K1's minima under each mode, ``flat_topk_fused`` under each mode,
``stage1_precision`` itself, the store reading it on each query, and the
flat index end to end. Inputs are made with numpy from a seed and fed to
both packages. The split3 and native kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.models.nn_index import flat as jax_flat
from smqtk_indexing_tpu.ops import device as jax_device
from smqtk_indexing_tpu.ops import pallas_scan as jax_scan
from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
from smqtk_indexing_tpu_torch.models.nn_index import flat as port_flat
from smqtk_indexing_tpu_torch.ops import device, fused_scan
from smqtk_indexing_tpu_torch.ops import store as port_store
from tests.test_torch_helpers import (
    assert_same_neighbours, elements_for, scan_inputs,
)

torch.set_num_threads(1)

#: K1's minima, port vs JAX (or float64), as a share of each segment's
#: largest |db_sq| + 2 |q| . |x|: both sum the same exact products of
#: bf16 parts (or of f32 values, "highest") in f32, in other orders.
#: Measured: 1.8e-7 for split3.
STAGE1_REL = 1e-6
#: Final distances: exact f32 formulas, summed in different orders.
DIST_RTOL = 1e-5
N = 8192


def _inputs(n, d, b, seed):
    db, sq, pen, q, valid = scan_inputs(n, d, b, seed)
    return db, sq, pen, q, valid


def _magnitude(db, sq, q, b, n):
    mag = np.abs(sq)[None, :].astype(np.float64) \
        + 2.0 * (np.abs(q).astype(np.float64) @ np.abs(db).T)
    return mag.reshape(b, n // 128, 128).max(-1)


def _assert_minima(out, ref, mag):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isinf(out), np.isinf(ref))
    fin = np.isfinite(ref)
    err = np.abs(out[fin] - ref[fin]) / mag[fin]
    assert err.max() <= STAGE1_REL, err.max()


def _split_both(x):
    """The port's and JAX's hi / lo parts of ``x`` as int16 bit patterns."""
    hi, lo = fused_scan.split_bf16(torch.from_numpy(x))
    assert hi.dtype == lo.dtype == torch.bfloat16
    j_hi = jnp.asarray(x).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(x) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    return ([p.view(torch.int16).numpy() for p in (hi, lo)],
            [np.asarray(p).view(np.int16) for p in (j_hi, j_lo)])


@pytest.mark.parametrize("scale", [1.0, 218.0, 2.0 ** -60, 2.0 ** 60])
@pytest.mark.parametrize("seed", [0, 1])
def test_split_is_bit_equal_to_jax_astype(seed, scale):
    # hi = bf16(x), lo = bf16(x - f32(hi)), both rounded to nearest even
    # as jnp.astype rounds: bit for bit where the parts are normal.
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    x[:3] = [0.0, -0.0, np.float32(scale)]
    port, jax_parts = _split_both(x)
    for p, j in zip(port, jax_parts):
        np.testing.assert_array_equal(p, j)


def test_split_keeps_subnormal_lo_parts_that_jax_on_cpu_flushes():
    # Rows near 2^-120: x - f32(hi) is an f32 subnormal. The port (torch,
    # and the kernel's cvt.rn.bf16x2.f32 without .ftz) rounds it to the
    # nearest even bf16 subnormal; XLA on the CPU flushes it to a signed
    # zero, as a TPU does. hi is the same in both.
    rng = np.random.default_rng(2)
    x = (rng.standard_normal(4096) * 2.0 ** -120).astype(np.float32)
    (hi, lo), (j_hi, j_lo) = _split_both(x)
    np.testing.assert_array_equal(hi, j_hi)
    back = (hi.astype(np.int32) << 16).view(np.float32).astype(np.float64)
    v = x.astype(np.float64) - back
    assert (np.abs(v) < 2.0 ** -126).all()
    q = 2.0 ** -133                     # the bf16 subnormal quantum
    want = np.round(v / q) * q          # half to even
    got = (lo.astype(np.int32) << 16).view(np.float32)
    np.testing.assert_array_equal(got.astype(np.float64), want)
    differ = lo != j_lo
    assert differ.mean() > 0.5
    assert (j_lo[differ] & 0x7FFF == 0).all()      # +-0 in JAX


@pytest.mark.parametrize("b", [8, 24])
@pytest.mark.parametrize("d", [128, 256])
@pytest.mark.parametrize("precision", ["split3", "highest"])
def test_segment_minima_matches_jax_precision(precision, d, b):
    db, sq, pen, q, _ = _inputs(N, d, b, seed=d + b)
    ref = np.asarray(jax_scan.segment_minima(
        jnp.asarray(db).T, jnp.asarray(sq)[None, :],
        jnp.asarray(pen)[None, :], jnp.asarray(q), interpret=True,
        precision=precision))
    before = dict(fused_scan.LAUNCHES)
    out = fused_scan.segment_minima(
        torch.from_numpy(db), torch.from_numpy(sq), torch.from_numpy(pen),
        torch.from_numpy(q), precision=precision).numpy()
    # The plain version on CPU tensors is not a kernel launch.
    assert fused_scan.LAUNCHES == before
    assert out.shape == (b, N // 128) and np.isinf(out[:, 1]).all()
    _assert_minima(out, ref, _magnitude(db, sq, q, b, N))


@pytest.mark.parametrize("b", [8, 24])
@pytest.mark.parametrize("d", [128, 256])
def test_native_matches_float64_over_bf16_operands(d, b):
    # One pass of the bf16-rounded query and rows: every product exact.
    db, sq, pen, q, _ = _inputs(N, d, b, seed=3 * d + b)
    out = fused_scan.segment_minima(
        torch.from_numpy(db), torch.from_numpy(sq), torch.from_numpy(pen),
        torch.from_numpy(q), precision="native").numpy()

    def rounded(a):
        return torch.from_numpy(a).to(torch.bfloat16).double().numpy()
    qr, xr = rounded(q), rounded(db)
    exact = ((sq.astype(np.float64)[None, :] - 2.0 * (qr @ xr.T))
             + pen.astype(np.float64)[None, :]) \
        .reshape(b, N // 128, 128).min(-1)
    _assert_minima(out, exact, _magnitude(xr, sq, qr, b, N))


def test_precision_applies_to_f32_only():
    # A bf16 database, int8 codes and an int8 query run "native" whatever
    # the precision says, as the JAX kernel does; an unknown precision is
    # refused.
    db, sq, pen, q, _ = _inputs(1024, 128, 8, seed=5)
    t = [torch.from_numpy(a) for a in (db, sq, pen, q)]
    xb = t[0].to(torch.bfloat16)
    outs = [fused_scan.segment_minima(xb, t[1], t[2], t[3], precision=p)
            for p in device.PRECISIONS]
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    codes = torch.from_numpy(np.clip(db * 20, -127, 127).astype(np.int8))
    for q_k in (t[3], codes[:8]):
        outs = [fused_scan.segment_minima(codes, t[1], t[2], q_k,
                                          precision=p)
                for p in device.PRECISIONS]
        assert all(torch.equal(outs[0], o) for o in outs[1:])
    with pytest.raises(ValueError, match="precision"):
        fused_scan.segment_minima(*t, precision="split4")


@pytest.mark.parametrize("metric", ["euclidean", "inner_product", "cosine"])
@pytest.mark.parametrize("precision", ["split3", "native", "highest"])
def test_flat_topk_fused_matches_jax_precision(precision, metric):
    n, d, b, k = N, 128, 16, 10
    db, sq, _, q, valid = _inputs(n, d, b, seed=7)
    norm = np.sqrt(sq)
    d_ref, r_ref = jax_scan.flat_topk_fused(
        jnp.asarray(db), jnp.asarray(sq), jnp.asarray(valid),
        jnp.asarray(q), k=k, metric=metric, db_norm=jnp.asarray(norm),
        interpret=True, precision=precision)
    d_port, r_port = fused_scan.flat_topk_fused(
        torch.from_numpy(db), torch.from_numpy(sq), torch.from_numpy(valid),
        torch.from_numpy(q), k=k, metric=metric,
        db_norm=torch.from_numpy(norm), precision=precision)
    assert valid[r_port.numpy()].all()
    assert_same_neighbours(r_port, d_port, r_ref, d_ref, rtol=DIST_RTOL,
                           atol=1e-6)


@pytest.mark.parametrize("value", [None, "split3", "native", "highest",
                                   "split", "HIGHEST", ""])
def test_stage1_precision_is_the_jax_function(monkeypatch, value):
    # Same name, values, default and error as ops/device.py:80-94.
    if value is None:
        monkeypatch.delenv("SMQTK_TPU_STAGE1", raising=False)
    else:
        monkeypatch.setenv("SMQTK_TPU_STAGE1", value)
    assert device.PRECISIONS == jax_scan.PRECISIONS
    if value is None or value in device.PRECISIONS:
        assert device.stage1_precision() == jax_device.stage1_precision() \
            == (value or "split3")
        return
    with pytest.raises(ValueError, match="SMQTK_TPU_STAGE1") as port:
        device.stage1_precision()
    with pytest.raises(ValueError) as jax_err:
        jax_device.stage1_precision()
    assert str(port.value) == str(jax_err.value)


def test_store_reads_the_variable_on_each_query(monkeypatch):
    rng = np.random.default_rng(11)
    x = rng.random((3000, 64), dtype=np.float32)
    store = port_store.VectorStore(device="cpu")
    store.build(x, list(range(3000)))
    assert store.knn(x[:1], 1)[1] == [[0]]
    seen = []
    real = port_store.flat_topk_fused

    def spy(*args, **kwargs):
        seen.append(kwargs["precision"])
        return real(*args, **kwargs)
    monkeypatch.setattr(port_store, "flat_topk_fused", spy)
    monkeypatch.delenv("SMQTK_TPU_STAGE1", raising=False)
    seen.clear()
    results = [store.knn(x[:5], 4)]
    for value in ("highest", "native", "split3"):
        monkeypatch.setenv("SMQTK_TPU_STAGE1", value)
        results.append(store.knn(x[:5], 4))
    assert seen == ["split3", "highest", "native", "split3"]
    for dists, uids, _ in results:
        assert [u[0] for u in uids] == list(range(5))
        np.testing.assert_array_equal(np.asarray(dists)[:, 0], 0.0)
    monkeypatch.setenv("SMQTK_TPU_STAGE1", "split-3")
    with pytest.raises(ValueError, match="SMQTK_TPU_STAGE1"):
        store.knn(x[:5], 4)
    assert len(seen) == 4


@pytest.mark.parametrize("value", [None, "native", "highest"])
def test_flat_index_under_each_mode_matches_jax(monkeypatch, value):
    # The slice end to end: the port's flat f32 index under each mode (its
    # stage 1 split3 by default) against the JAX index on the same data
    # (the JAX CPU scan is exact f32), ids and distances.
    if value is None:
        monkeypatch.delenv("SMQTK_TPU_STAGE1", raising=False)
    else:
        monkeypatch.setenv("SMQTK_TPU_STAGE1", value)
    rng = np.random.default_rng(12)
    x = rng.random((2000, 96), dtype=np.float32) * 218.0
    q = rng.random((24, 96), dtype=np.float32) * 218.0
    elems = [DescriptorMemoryElement(i, x[i]) for i in range(2000)]
    queries = [DescriptorMemoryElement(("q", i), q[i]) for i in range(24)]
    out = []
    for index in (port_flat.FlatNearestNeighborsIndex(device="cpu"),
                  jax_flat.FlatNearestNeighborsIndex()):
        index.build_index(elements_for(index, elems))
        index.remove_from_index(list(range(0, 2000, 9)))
        res = index.nn_many(elements_for(index, queries), 10)
        out.append((np.array([[e.uuid() for e in r[0]] for r in res]),
                    np.array([r[1] for r in res], dtype=np.float64)))
    (ids, dists), (ids_ref, dists_ref) = out
    assert_same_neighbours(ids, dists, ids_ref, dists_ref, rtol=DIST_RTOL,
                           atol=1e-4)
