"""
The port's ``examples/ivf_100m.py`` (``smqtk_indexing_tpu_torch.examples
.ivf_100m``) on the CPU: its mini run end to end with its recall checks,
its mixture components against the JAX example's formula, and its CSR and
slot table against the JAX package's builders on the same chunk lengths.
"""
import importlib

import numpy as np
import pytest
import torch

from smqtk_indexing_tpu.ops.pallas_ivf import (
    build_slot_table as jax_slot_table, build_tiled_csr as jax_tiled_csr,
)
from smqtk_indexing_tpu_torch.ops import ivf_scan

torch.set_num_threads(1)


@pytest.fixture
def mini(monkeypatch):
    """The example module under ``SMQTK_IVF100M_MINI=1`` at two chunks
    (its switches are read at import), with the query batches and
    repetitions cut for one CPU thread."""
    monkeypatch.setenv("SMQTK_IVF100M_MINI", "1")
    monkeypatch.setenv("SMQTK_IVF100M_CHUNKS", "2")
    for name in ("NO_SQ8", "NO_PQ", "OPQ", "RAW_PQ"):
        monkeypatch.delenv("SMQTK_IVF100M_" + name, raising=False)
    from smqtk_indexing_tpu_torch.examples import ivf_100m
    mod = importlib.reload(ivf_100m)
    monkeypatch.setattr(mod, "B", 4)
    monkeypatch.setattr(mod, "B_LARGE", 8)
    monkeypatch.setattr(mod, "REPS", 1)
    yield mod
    monkeypatch.undo()
    importlib.reload(ivf_100m)


def test_mini_run_on_cpu(mini):
    records = mini.main(device="cpu")
    names = [r["metric"] for r in records]
    for nprobe in (2, 4, 8, 16):
        assert f"ivf16384_sq8_mini_nprobe{nprobe}" in names
        assert f"ivf16384_pq16_mini_nprobe{nprobe}" in names
    # SQ8 against the exhaustive oracle, PQ against the ADC oracle.
    mini.check_recall(records)
    assert all(r["device"] == "cpu" for r in records)
    layout = records[names.index("ivf16384_mini_layout")]
    assert layout["value"] >= mini.C_LISTS


def test_rows_regenerate_and_components_match_jax_formula(mini):
    centers = mini.make_centers("cpu")
    ids = torch.arange(0, 2 * mini.CHUNK, 977)
    want = (ids.numpy().astype(np.uint32) * np.uint32(2654435761)
            % np.uint32(mini.L_GEN)).astype(np.int64)
    np.testing.assert_array_equal(mini.components(ids).numpy(), want)
    # Two passes over a chunk draw the same rows; the training sample is
    # a prefix of chunk 0; each row sits near its component's centre.
    a = mini.chunk_rows(centers, 1)
    assert torch.equal(a, mini.chunk_rows(centers, 1))
    assert torch.equal(mini.chunk_rows(centers, 0, mini.TRAIN_ROWS),
                       mini.chunk_rows(centers, 0)[:mini.TRAIN_ROWS])
    own = centers[mini.components(torch.arange(mini.CHUNK,
                                               2 * mini.CHUNK))]
    assert float((a - own).std()) == pytest.approx(mini.SIGMA, rel=0.05)


@pytest.mark.parametrize("n_chunks,c_lists", [(4, 64), (3, 300)])
def test_csr_and_slot_table_match_jax(n_chunks, c_lists):
    rng = np.random.default_rng(n_chunks)
    chunk = 4 * 4096
    lens = np.stack([np.bincount(rng.integers(0, c_lists, chunk) ** 2
                                 // c_lists, minlength=c_lists)
                     for _ in range(n_chunks)])
    bases = np.arange(n_chunks, dtype=np.int64) * chunk
    got = ivf_scan.build_tiled_csr(lens, bases)
    want = jax_tiled_csr(lens, bases)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(ivf_scan.build_slot_table(got[3], c_lists),
                                  np.asarray(jax_slot_table(want[3],
                                                            c_lists)))


def test_sq8_above_20_chunks_needs_no_sq8(monkeypatch):
    monkeypatch.setenv("SMQTK_IVF100M_CHUNKS", "21")
    for name in ("MINI", "NO_SQ8"):
        monkeypatch.delenv("SMQTK_IVF100M_" + name, raising=False)
    from smqtk_indexing_tpu_torch.examples import ivf_100m
    mod = importlib.reload(ivf_100m)
    try:
        with pytest.raises(ValueError, match="NO_SQ8"):
            mod.main(device="cpu")
    finally:
        monkeypatch.undo()
        importlib.reload(ivf_100m)
