"""
The flat batch timer (``smqtk_indexing_tpu_torch/tools/flat_batches.py``)
at a small size on the CPU: one record a batch, every span of the flat
path in each, and the same data recipe as the flat phase of
``chip_smoke.py``.
"""
import types

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


class _Index:
    """Counts one K1 launch a batch into ``mod``, as the flat index's
    batches do on the card."""

    def __init__(self, mod, key):
        self.mod, self.key = mod, key

    def nn_many(self, q_elems, k):
        if self.key is None:
            self.mod.LAUNCHES += 1
        else:
            self.mod.LAUNCHES[self.key] += 1


@pytest.mark.parametrize("form", ["dict", "int", "int_with_i8dot"])
def test_counts_k1_in_old_and_new_packages(form, monkeypatch):
    # ``--root`` may import a checkout whose LAUNCHES is still an int.
    import smqtk_indexing_tpu_torch.ops as ops
    if form == "dict":
        mod = types.SimpleNamespace(LAUNCHES={
            ("segment_minima", "wgmma"): 7, ("segment_minima", "ffma"): 1,
            ("segment_minima_tiled", "wgmma"): 4})
        key = ("segment_minima", "wgmma")
    else:
        mod = types.SimpleNamespace(LAUNCHES=7)
        key = None
        if form == "int_with_i8dot":
            mod.I8DOT_LAUNCHES = {"segment_minima": 2,
                                  "segment_minima_tiled": 3}
    monkeypatch.setattr(ops, "fused_scan", mod)
    batches = flat_batches.time_batches(_Index(mod, key), [], 3)
    assert len(batches) == 3
    # The warm-up's launch and the earlier counts are gone.
    assert flat_batches.k1_launches(mod) == 3
    if form == "dict":
        assert mod.LAUNCHES[("segment_minima_tiled", "wgmma")] == 0
    if form == "int_with_i8dot":
        assert mod.I8DOT_LAUNCHES == {"segment_minima": 0,
                                      "segment_minima_tiled": 3}
