"""
The K1 timer (``smqtk_indexing_tpu_torch/tools/k1_times.py``) on the CPU:
its operands are seeded and shaped as the flat SQ8 and f32 stores', it
times each f32 precision where ``segment_minima`` takes one and the one
f32 form of a checkout from before, and it refuses to time anything
without a card.
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


def test_f32_operands_are_seeded_and_shaped():
    x, sq, penalty, q = k1_times.make_f32_operands(256, 32, 4, "cpu")
    again = k1_times.make_f32_operands(256, 32, 4, "cpu")
    for a, b in zip((x, sq, penalty, q), again):
        assert torch.equal(a, b)
    assert x.shape == (256, 32) and q.shape == (4, 32)
    assert x.dtype == q.dtype == torch.float32
    assert 0.0 <= x.min() and x.max() <= 218.0
    torch.testing.assert_close(sq, (x * x).sum(-1))
    assert set(penalty.unique().tolist()) <= {0.0, float("inf")}


def test_f32_forms_follow_the_checkout():
    # This checkout's segment_minima takes each precision; one from
    # before the precisions were ported has a single (FFMA) f32 form.
    from smqtk_indexing_tpu_torch.ops import fused_scan
    assert k1_times.f32_forms(fused_scan.segment_minima) == {
        "f32_split3": {"precision": "split3"},
        "f32_native": {"precision": "native"},
        "f32_highest": {"precision": "highest"}}

    def before(db, db_sq, penalty, q):
        return None
    assert k1_times.f32_forms(before) == {"f32": {}}


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        k1_times.main([])
