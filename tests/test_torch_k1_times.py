"""
The K1 timer (``smqtk_indexing_tpu_torch/tools/k1_times.py``) on the CPU:
its operands are seeded and shaped as the flat SQ8 store's, and the tool
refuses to time anything without a card.
"""
import pytest
import torch

from smqtk_indexing_tpu_torch.tools import k1_times

torch.set_num_threads(1)


def test_operands_are_seeded_and_shaped():
    codes, db_sq, penalty, t = k1_times.make_operands(256, 32, 4, "cpu")
    again = k1_times.make_operands(256, 32, 4, "cpu")
    for x, y in zip((codes, db_sq, penalty, t), again):
        assert torch.equal(x, y)
    assert codes.dtype == torch.int8 and codes.shape == (256, 32)
    assert db_sq.shape == penalty.shape == (256,)
    assert t.shape == (4, 32) and t.dtype == torch.float32
    assert set(penalty.unique().tolist()) <= {0.0, float("inf")}
    assert (db_sq >= 0).all()


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        k1_times.main([])
