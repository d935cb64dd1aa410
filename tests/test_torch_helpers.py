"""Helpers shared by the port's tests (``tests/test_torch_*.py``); no tests
of its own. Imports no jax, so the card-only tests can use it on a machine
without jax."""
import numpy as np


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
