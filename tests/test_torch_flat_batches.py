"""
The flat batch timer (``smqtk_indexing_tpu_torch/tools/flat_batches.py``)
at a small size on the CPU: one record a batch, every span of the flat
path in each, and the same data recipe as the flat phase of
``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu_torch.tools import flat_batches

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "sq8"])
def test_records_each_batch(dtype, capsys):
    out = flat_batches.main(["--device", "cpu", "--dtype", dtype,
                             "--n", "1000", "--batch", "8",
                             "--batches", "3"])
    assert capsys.readouterr().out.count("\n") == 1
    assert out["dtype"] == dtype and out["n"] == 1000
    assert len(out["batch_ms"]) == len(out["split_ms"]) \
        == len(out["gc_collections"]) == 3
    for ms, split, gcs in zip(out["batch_ms"], out["split_ms"],
                              out["gc_collections"]):
        assert set(split) == set(flat_batches.SPANS)
        assert 0.0 < split["store.knn"] <= split["flat.query"] <= ms
        assert len(gcs) == 3 and min(gcs) >= 0
    # A CPU tensor takes the plain version, which counts no launch.
    assert out["segment_minima_launches"] == 0


def test_flat_data_matches_the_seeded_recipe():
    data, queries = flat_batches.flat_data(50, 8, 4)
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(
        data, rng.random((50, 8), dtype=np.float32) * 218.0)
    np.testing.assert_array_equal(
        queries, rng.random((4, 8), dtype=np.float32) * 218.0)
    assert data.dtype == np.float32
