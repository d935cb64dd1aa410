"""Helpers shared by the port's tests (``tests/test_torch_*.py``); no tests
of its own. Importing it imports no jax and nothing of the JAX package, so
the card-only tests can use it on a machine without jax."""
import numpy as np


def chunked_tiled_layout(n_chunks=2, c_lists=16, d=128, seed=0):
    """``tests/ops/test_pallas_ivf_tiled.py``'s layout, made by numpy from
    ``seed``: per-chunk list-sorted clustered rows, one tile a chunk, the
    SQ8 codec (the port's, bit-equal to JAX's), the virtual-sublist CSR and
    each list's mean as its centroid."""
    from smqtk_indexing_tpu_torch.ops import ivf_scan
    from smqtk_indexing_tpu_torch.ops.sq8 import sq8_encode_np, sq8_train
    tile = ivf_scan.TILE_ROWS
    rng = np.random.default_rng(seed)
    n = n_chunks * tile
    centers = rng.normal(size=(c_lists, d)).astype(np.float32) * 2.0
    rows = np.empty((n, d), np.float32)
    chunk_lens = np.zeros((n_chunks, c_lists), np.int64)
    assigns = np.empty(n, np.int32)
    for c in range(n_chunks):
        a_c = np.sort(rng.integers(0, c_lists, size=tile))
        chunk_lens[c] = np.bincount(a_c, minlength=c_lists)
        rows[c * tile:(c + 1) * tile] = (
            centers[a_c] + rng.normal(size=(tile, d)).astype(np.float32)
            * 0.3)
        assigns[c * tile:(c + 1) * tile] = a_c
    a, b = sq8_train(rows)
    codes = sq8_encode_np(rows, a, b)
    u = codes.astype(np.float64)
    s2 = ((a.astype(np.float64) * u) ** 2).sum(1).astype(np.float32)
    csr = ivf_scan.build_tiled_csr(chunk_lens, np.arange(n_chunks) * tile)
    cents = np.stack([rows[assigns == li].mean(0) for li in range(c_lists)]
                     ).astype(np.float32)
    return {"db3": np.ascontiguousarray(
                codes.reshape(n_chunks, tile, d).transpose(0, 2, 1)),
            "s2t": s2.reshape(n_chunks, 1, tile), "a": a, "b": b,
            "cents": cents, "csr": csr, "dq": u * a + b, "assigns": assigns}


def near_rows(dq, b, seed):
    """``b`` queries near rows of ``dq`` (float32), from ``seed``."""
    rng = np.random.default_rng(seed)
    return (dq[rng.integers(0, dq.shape[0], b)]
            + rng.normal(size=(b, dq.shape[1])) * 0.1).astype(np.float32)


def scan_inputs(n, d, b, seed, dead_frac=0.02):
    """(db, db_sq, penalty, q, valid) for a stage-1 scan, made by numpy
    from ``seed``: 2% dead rows plus one wholly dead segment (rows
    128-255)."""
    rng = np.random.default_rng(seed)
    db = (rng.normal(size=(n, d)) * 3).astype(np.float32)
    q = (rng.normal(size=(b, d)) * 3).astype(np.float32)
    dead = rng.random(n) < dead_frac
    dead[128:256] = True
    sq = np.einsum("ij,ij->i", db, db).astype(np.float32)
    pen = np.where(dead, np.inf, 0.0).astype(np.float32)
    return db, sq, pen, q, ~dead


def assert_same_neighbours(ids_port, d_port, ids_ref, d_ref, rtol,
                           atol=0.0):
    """Sorted (B, k) distances agree within (rtol, atol); the id sets of
    each query agree except for entries tied with the k-th distance within
    the same tolerance."""
    ids_port, ids_ref = np.asarray(ids_port), np.asarray(ids_ref)
    d_port = np.asarray(d_port, dtype=np.float64)
    d_ref = np.asarray(d_ref, dtype=np.float64)
    np.testing.assert_allclose(d_port, d_ref, rtol=rtol, atol=atol)
    for i in range(ids_ref.shape[0]):
        diff = set(ids_port[i].tolist()) ^ set(ids_ref[i].tolist())
        kth = float(d_ref[i, -1])
        lookup = dict(zip(ids_port[i].tolist(), d_port[i].tolist()))
        lookup.update(zip(ids_ref[i].tolist(), d_ref[i].tolist()))
        for u in diff:
            assert abs(lookup[u] - kth) <= atol + rtol * abs(kth), \
                f"query {i}: id {u} at {lookup[u]} is not a tie with {kth}"


def assert_valid_lsh_answer(uids, dists, qv, q_code, row_codes, x, n,
                            rtol, atol):
    """``uids`` / ``dists`` (one query's euclidean LSH answer, uids being
    rows of ``x``) come from the n nearest codes for some choice among the
    codes tied at the n-th Hamming distance: every row's code lies within
    the n-th distance, the distances are the float64 ones of those rows
    within (rtol, atol), ascending, and no row of a code strictly inside
    the n-th distance is left out with a smaller distance than the last
    one returned. ``row_codes`` holds each row's (bits,) bool code."""
    uids = np.asarray(uids, dtype=np.int64)
    dists = list(dists)
    uniq = np.unique(row_codes, axis=0)
    d_n = np.sort((uniq ^ q_code).sum(-1))[n - 1]
    ham = (row_codes ^ q_code).sum(-1)
    qv = np.asarray(qv, dtype=np.float64)
    exact = np.sqrt(((x.astype(np.float64) - qv) ** 2).sum(-1))
    assert (ham[uids] <= d_n).all()
    np.testing.assert_allclose(dists, exact[uids], rtol=rtol, atol=atol)
    assert dists == sorted(dists) and len(set(uids.tolist())) == len(uids)
    must = np.flatnonzero(ham < d_n)
    assert len(uids) >= min(n, len(must))
    if len(uids) == n:
        left_out = np.setdiff1d(must, uids)
        assert (exact[left_out] >= dists[-1] - atol).all()


def elements_for(index, elems):
    """``elems`` as descriptor elements of ``index``'s own package, with the
    same uids and vectors: each package's index gets its own elements, built
    from the same numpy arrays. The JAX package is imported only for a JAX
    index."""
    if type(index).__module__.startswith("smqtk_indexing_tpu_torch."):
        from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement
    else:
        from smqtk_indexing_tpu.data import DescriptorMemoryElement
    return [e if type(e) is DescriptorMemoryElement
            else DescriptorMemoryElement(e.uuid(), e.vector()) for e in elems]
