"""
The port's packed-code Hamming top-k and code store
(``smqtk_indexing_tpu_torch/ops/hamming.py``) against the JAX package's
``ops/hamming.py`` on the same packed inputs, made by numpy from a seed.

On the CPU the JAX store serves the host scan below ``HOST_SCAN_MAX``
rows and the XOR route above it (its ±1 route needs a TPU), so the port's
host and XOR routes are held to it row for row, distances and codes, and
the port's ±1 route (K1's bf16 form through ``flat_topk_fused``; its
plain version here) to the same distances, with rows free only among ties
at the k-th distance. 16-bit codes make many ties. One small case runs
the JAX store's own ±1 route (its Pallas kernel in interpret mode).
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops import hamming as jax_hamming
from smqtk_indexing_tpu_torch.ops import fused_scan, hamming
from smqtk_indexing_tpu_torch.ops.lsh_fused import pack_bits_device
from smqtk_indexing_tpu_torch.utils.bits import (
    bit_vector_to_int_large, pack_bit_vectors_u32,
)

torch.set_num_threads(1)


def _codes(n, width, seed):
    return np.random.default_rng(seed).integers(
        0, 2, size=(n, width)).astype(bool)


def _words(packed):
    return hamming.words_to_tensor(packed, "cpu")


def test_popcount32_matches_numpy():
    rng = np.random.default_rng(0)
    w = np.concatenate([
        np.array([0, 1, 0x80000000, 0xFFFFFFFF, 0x7FFFFFFF, 0x55555555],
                 dtype=np.uint32),
        rng.integers(0, 2 ** 32, size=5000, dtype=np.uint64)
        .astype(np.uint32)])
    got = hamming.popcount32(_words(w[:, None])[:, 0]).numpy()
    assert np.array_equal(got, np.bitwise_count(w))
    assert got[:6].tolist() == [bin(int(x)).count("1") for x in w[:6]]


@pytest.mark.parametrize("width", [1, 31, 33, 128, 256])
def test_pack_bits_device_matches_utils_bits(width):
    mat = _codes(19, width, seed=width)
    got = pack_bits_device(torch.from_numpy(mat))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().view(np.uint32),
                          pack_bit_vectors_u32(mat))


@pytest.mark.parametrize("width,n,k,chunk", [
    (8, 512, 8, 512), (16, 1536, 20, 256), (32, 512, 8, 512),
    (96, 1024, 16, 256), (256, 512, 8, 512)])
def test_hamming_topk_matches_jax(width, n, k, chunk):
    db = pack_bit_vectors_u32(_codes(n, width, seed=width))
    q = pack_bit_vectors_u32(_codes(16, width, seed=width + 1))
    valid = np.random.default_rng(width).random(n) > 0.1
    jd, jr = jax_hamming.hamming_topk(db, valid, q, k=k, chunk=chunk)
    # The port streams blocks of its own size; the order is exact.
    dd, rr = hamming.hamming_topk(_words(db), torch.from_numpy(valid),
                                  _words(q), k=k, chunk=chunk // 2 + 3)
    assert dd.dtype == torch.int32 and rr.dtype == torch.int32
    assert np.array_equal(dd.numpy(), np.asarray(jd))
    assert np.array_equal(rr.numpy(), np.asarray(jr))


def test_hamming_topk_pads_past_valid_rows():
    db = pack_bit_vectors_u32(_codes(64, 24, seed=2))
    q = pack_bit_vectors_u32(_codes(3, 24, seed=3))
    valid = np.zeros(64, dtype=bool)
    valid[[5, 17, 40]] = True
    dd, rr = hamming.hamming_topk(_words(db), torch.from_numpy(valid),
                                  _words(q), k=100, chunk=16)
    assert dd.shape == (3, 100)
    assert (rr[:, :3].sort(1).values == torch.tensor([5, 17, 40])).all()
    assert (rr[:, 3:] == -1).all() and (dd[:, 3:] == hamming.INVALID).all()


def _stores(mat):
    port = hamming.CodeStore(device="cpu")
    port.build(mat)
    ref = jax_hamming.CodeStore()
    ref.build(mat)
    return port, ref


def _same_up_to_kth_ties(q, d, codes, d_ref, codes_ref):
    """Equal distances; the codes of each query agree except among those
    at the k-th distance."""
    assert np.array_equal(d, d_ref)
    assert np.array_equal((q[:, None, :] ^ codes).sum(-1), d)
    for i in range(q.shape[0]):
        below = d[i] < d[i, -1]
        a = {c.tobytes() for c in codes[i][below]}
        b = {c.tobytes() for c in codes_ref[i][below]}
        assert a == b
        assert len({c.tobytes() for c in codes[i]}) == codes.shape[1]


@pytest.mark.parametrize("route,n", [("host", 1800), ("xor", 20000),
                                     ("pm1", 20000)])
def test_code_store_routes_match_jax(route, n, monkeypatch):
    # 16-bit codes: thousands of unique codes, many ties at every k.
    mat = _codes(n, 16, seed=n)
    q = _codes(13, 16, seed=7)
    if route == "xor":
        monkeypatch.setenv("SMQTK_TPU_NO_MXU_HAMMING", "1")
    port, ref = _stores(mat)
    assert port.ints() == ref.ints()
    seen = []
    real = fused_scan.segment_minima
    monkeypatch.setattr(fused_scan, "segment_minima",
                        lambda *a, **kw: seen.append(a[0].dtype)
                        or real(*a, **kw))
    d, codes = port.knn(q, 9)
    d_ref, codes_ref = ref.knn(q, 9)
    assert d.dtype == np.int32 and codes.shape == (13, 9, 16)
    if route == "pm1":
        # K1's bf16 form on the ±1 mirror, bits padded to 128.
        assert port._capacity >= hamming.MXU_SCAN_MIN
        assert seen == [torch.bfloat16]
        assert port._dev_pm1.shape == (port._capacity, 128)
        _same_up_to_kth_ties(q, d, codes, d_ref, codes_ref)
    else:
        assert seen == [] and port._dev_pm1 is None
        assert np.array_equal(d, d_ref)
        assert np.array_equal(codes, codes_ref)


def test_no_mxu_hamming_switch_is_read_per_query(monkeypatch):
    mat = _codes(20000, 16, seed=3)
    q = _codes(5, 16, seed=4)
    port, ref = _stores(mat)
    d_pm1, _ = port.knn(q, 6)
    assert port._dev_pm1 is not None
    monkeypatch.setenv("SMQTK_TPU_NO_MXU_HAMMING", "1")
    called = []
    monkeypatch.setattr(fused_scan, "flat_topk_fused",
                        lambda *a, **kw: called.append(1))
    d_xor, codes_xor = port.knn(q, 6)
    assert called == []
    d_ref, codes_ref = ref.knn(q, 6)
    assert np.array_equal(d_xor, d_ref) and np.array_equal(d_pm1, d_ref)
    assert np.array_equal(codes_xor, codes_ref)


def test_pm1_route_mutations_match_jax():
    """add() writes the new rows into the ±1 mirror in place; remove()
    flips validity, then compacts; both stores stay equal."""
    bits = 16
    mat = _codes(12000, bits, seed=21)
    extra = _codes(900, bits, seed=22)
    q = np.vstack([extra[:4], _codes(4, bits, seed=23)])
    port, ref = _stores(mat)
    port.knn(q, 3)
    mirror = port._dev_pm1
    assert mirror is not None
    for store in (port, ref):
        store.add(extra)
    assert port._dev_pm1 is mirror           # capacity unchanged
    assert port.n_valid == ref.n_valid and port.ints() == ref.ints()
    d, codes = port.knn(q, 5)
    d_ref, codes_ref = ref.knn(q, 5)
    _same_up_to_kth_ties(q, d, codes, d_ref, codes_ref)
    assert (d[:4, 0] == 0).all()
    live = np.unique(np.vstack([mat, extra]), axis=0)
    gone = live[::3]
    for store in (port, ref):
        store.remove(gone)
    assert port.n_valid == ref.n_valid and port.ints() == ref.ints()
    d, codes = port.knn(q, 5)
    d_ref, codes_ref = ref.knn(q, 5)
    _same_up_to_kth_ties(q, d, codes, d_ref, codes_ref)
    # Compaction below half full rebuilds the mirror.
    for store in (port, ref):
        store.remove(live[1::3])
    assert port._dev_pm1 is None and port.ints() == ref.ints()
    d, codes = port.knn(q, 5)
    d_ref, codes_ref = ref.knn(q, 5)
    assert np.array_equal(d, d_ref)


def test_remove_missing_keyerror_no_mutation():
    mat = _codes(300, 24, seed=1)
    port, _ = _stores(mat)
    before = port.ints()
    missing = next(c for c in _codes(50, 24, seed=2)
                   if not port.has_int(bit_vector_to_int_large(c)))
    with pytest.raises(KeyError):
        port.remove(np.vstack([mat[0], missing]))
    assert port.ints() == before and port.n_valid == len(before)


@pytest.mark.parametrize("n", [700, 5000])
def test_payloads_load_both_ways(n):
    mat = _codes(n, 40, seed=n)
    q = _codes(6, 40, seed=n + 1)
    port, ref = _stores(mat)
    port.remove(mat[:50])
    ref.remove(mat[:50])
    from_jax = hamming.CodeStore(device="cpu")
    from_jax.from_bytes(ref.to_bytes())
    from_port = jax_hamming.CodeStore()
    from_port.from_bytes(port.to_bytes())
    assert from_jax.ints() == ref.ints() == from_port.ints()
    for a, b in ((from_jax, ref), (from_port, port)):
        da, ca = a.knn(q, 4)
        db_, cb = b.knn(q, 4)
        assert np.array_equal(da, db_) and np.array_equal(ca, cb)
    empty = hamming.CodeStore(device="cpu")
    jax_empty = jax_hamming.CodeStore()
    jax_empty.from_bytes(empty.to_bytes())
    empty.from_bytes(jax_hamming.CodeStore().to_bytes())
    assert empty.n_valid == jax_empty.n_valid == 0


def test_pm1_route_matches_jax_pm1_route(monkeypatch):
    """The JAX store's own ±1 route (its Pallas kernel in interpret mode)
    on one small case: the same distances."""
    mat = _codes(3000, 128, seed=42)
    q = np.vstack([mat[:3], _codes(5, 128, seed=43)])
    monkeypatch.setattr(jax_hamming.CodeStore, "_mxu_eligible",
                        lambda self: True)
    monkeypatch.setattr(hamming, "MXU_SCAN_MIN", 4096)
    port, ref = _stores(mat)
    d, codes = port.knn(q, 5)
    assert port._dev_pm1 is not None
    d_ref, codes_ref = ref.knn(q, 5)
    assert ref._dev_pm1 is not None
    _same_up_to_kth_ties(q, d, codes, d_ref, codes_ref)


def test_store_refuses_mesh_and_missing_card():
    # A mesh of cards needs the cards: no fallback to the CPU.
    from smqtk_indexing_tpu_torch.parallel.mesh import make_mesh
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            hamming.CodeStore(mesh=make_mesh(2, device="cuda"))
        with pytest.raises(RuntimeError, match="cuda"):
            hamming.CodeStore()
