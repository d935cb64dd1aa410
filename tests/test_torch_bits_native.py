"""
The port's copies of ``utils/bits.py`` and the native host library
(``smqtk_indexing_tpu_torch/utils/bits.py``, ``.../native/``) against the
JAX package's: the same packed words bit for bit, the same integers, the
same host Hamming top-k (distance, then ascending row), the same
``.fvecs`` / ``.bvecs`` reads, and the JAX package's switches
``SMQTK_TPU_NO_NATIVE`` and ``SMQTK_TPU_NATIVE_CACHE``.
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu import native as jax_native
from smqtk_indexing_tpu.utils import bits as jax_bits
from smqtk_indexing_tpu_torch import native
from smqtk_indexing_tpu_torch.utils import bits

torch.set_num_threads(1)

BITS = (1, 7, 31, 32, 33, 100, 128, 256)


def _codes(n, width, seed):
    return np.random.default_rng(seed).integers(
        0, 2, size=(n, width)).astype(bool)


@pytest.mark.parametrize("width", BITS)
def test_packing_matches_jax(width):
    mat = _codes(37, width, seed=width)
    packed = bits.pack_bit_vectors_u32(mat)
    assert packed.dtype == np.uint32
    assert packed.shape == (37, (width + 31) // 32)
    assert np.array_equal(packed, jax_bits.pack_bit_vectors_u32(mat))
    assert np.array_equal(bits.unpack_bit_vectors_u32(packed, width), mat)
    ints = bits.bit_matrix_to_ints(mat)
    assert ints == jax_bits.bit_matrix_to_ints(mat)
    assert ints == [bits.bit_vector_to_int_large(r) for r in mat]
    assert np.array_equal(bits.ints_to_packed_u32(ints, width), packed)
    assert bits.packed_u32_to_ints(packed, width) == ints
    for i, r in zip(ints[:5], mat[:5]):
        assert np.array_equal(bits.int_to_bit_vector_large(i, width), r)


def test_big_endian_bit_order():
    # Bit 0 is the most significant bit (reference itq.py:46-50).
    assert bits.bit_vector_to_int_large([1, 0, 1]) == 5
    assert bits.int_to_bit_vector_large(1, bits=4).tolist() == \
        [False, False, False, True]
    with pytest.raises(ValueError):
        bits.int_to_bit_vector_large(16, bits=4)


def test_native_builds_and_packs_like_numpy():
    assert native.available(), "native library failed to build/load"
    mat = _codes(50, 77, seed=3)
    packed = native.pack_bits(mat)
    assert np.array_equal(packed, bits.pack_bit_vectors_u32(mat))
    assert np.array_equal(packed, jax_native.pack_bits(mat))
    assert np.array_equal(native.unpack_bits(packed, 77), mat)


@pytest.fixture
def numpy_fallback(monkeypatch):
    """The port's native module as it runs without the library."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", True)


@pytest.mark.parametrize("width,k", [(16, 9), (64, 5), (96, 12)])
def test_host_hamming_topk_matches_jax(width, k):
    # 16-bit codes tie often: ties must come out in ascending row order,
    # as the JAX host scan returns them.
    db = bits.pack_bit_vectors_u32(_codes(600, width, seed=width))
    q = bits.pack_bit_vectors_u32(_codes(7, width, seed=width + 1))
    valid = np.random.default_rng(width).random(600) > 0.2
    dd, rr = native.hamming_topk(db, valid, q, k)
    jd, jr = jax_native.hamming_topk(db, valid, q, k)
    assert np.array_equal(dd, jd) and np.array_equal(rr, jr)
    # Distances from numpy's popcount; ties in ascending row order.
    ref = np.bitwise_count(db[None, :, :] ^ q[:, None, :]).sum(-1)
    ref = np.where(valid[None, :], ref, np.iinfo(np.int32).max)
    order = np.lexsort((np.broadcast_to(np.arange(600), ref.shape), ref),
                       axis=1)[:, :k]
    assert np.array_equal(rr, order)
    assert np.array_equal(dd, np.take_along_axis(ref, order, axis=1))


def test_host_hamming_topk_numpy_fallback(numpy_fallback):
    db = bits.pack_bit_vectors_u32(_codes(40, 16, seed=5))
    q = bits.pack_bit_vectors_u32(_codes(3, 16, seed=6))
    valid = np.ones(40, dtype=bool)
    valid[::3] = False
    assert not native.available()
    dd, rr = native.hamming_topk(db, valid, q, 50)   # more than live rows
    jd, jr = jax_native.hamming_topk(db, valid, q, 50)
    assert np.array_equal(dd, jd) and np.array_equal(rr, jr)
    assert (rr[:, 26:] == -1).all()
    assert (dd[:, 26:] == np.iinfo(np.int32).max).all()


def test_no_native_switch(monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("SMQTK_TPU_NO_NATIVE", "1")
    assert native.lib() is None and not native.available()
    mat = _codes(4, 40, seed=8)
    assert np.array_equal(native.pack_bits(mat),
                          bits.pack_bit_vectors_u32(mat))


def test_native_cache_switch(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    monkeypatch.setenv("SMQTK_TPU_NATIVE_CACHE", str(tmp_path))
    assert native.available()
    built = list(tmp_path.glob("_native_*.so"))
    assert len(built) == 1 and not list(tmp_path.glob("*.tmp"))


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("kind", ["fvecs", "bvecs"])
def test_read_vecs_matches_jax(tmp_path, monkeypatch, kind, fallback):
    if fallback:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    rng = np.random.default_rng(11)
    dim, n = 12, 9
    path = str(tmp_path / f"x.{kind}")
    if kind == "fvecs":
        x = rng.normal(size=(n, dim)).astype(np.float32)
        rows = np.hstack([np.full((n, 1), dim, np.int32).view(np.float32),
                          x])
        rows.tofile(path)
    else:
        x = rng.integers(0, 256, size=(n, dim)).astype(np.uint8)
        hdr = np.full((n, 1), dim, np.int32).view(np.uint8).reshape(n, 4)
        np.hstack([hdr, x]).tofile(path)
    out = native.read_vecs(path, 100, dim)
    assert out.dtype == np.float32
    assert np.array_equal(out, x.astype(np.float32))
    assert np.array_equal(out, jax_native.read_vecs(path, 100, dim))
    assert native.read_vecs(path, 4, dim).shape == (4, dim)
    with pytest.raises(ValueError):
        native.read_vecs(path, 100, dim + 1)
