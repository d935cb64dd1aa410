"""
The stage-1 split tool (``smqtk_indexing_tpu_torch/tools/tiled_wgmma_split.py``)
on the CPU: each knock-out still finds its text in the kernel's source, so
the tool times what it says, and the tool refuses to run without a card.
"""
import pytest
import torch

from smqtk_indexing_tpu_torch.tools import tiled_wgmma_split as split


@pytest.mark.parametrize("name", list(split.KNOCKOUTS))
def test_each_knockout_applies_once(name):
    full = split.variant_source("full")
    text = split.variant_source(name)
    if name == "full":
        assert text == (split._kernels.CSRC / split.SOURCE).read_text()
        return
    assert text != full
    for old, new in split.KNOCKOUTS[name]:
        assert full.count(old) == 1 and old not in text


def test_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        split.main([])


# K8's split (smqtk_indexing_tpu_torch/tools/pq_adc_split.py) builds its
# copies with the same build function.

@pytest.mark.parametrize("name", ["full", "nolookup", "nowork",
                                  "nostream"])
def test_each_k8_knockout_applies_once(name):
    from smqtk_indexing_tpu_torch.tools import pq_adc_split as k8
    assert set(k8.KNOCKOUTS) == {"full", "nolookup", "nowork", "nostream"}
    full = split.variant_source("full", k8.SOURCE, k8.KNOCKOUTS)
    text = split.variant_source(name, k8.SOURCE, k8.KNOCKOUTS)
    if name == "full":
        assert text == (split._kernels.CSRC / k8.SOURCE).read_text()
        return
    for old, new in k8.KNOCKOUTS[name]:
        assert full.count(old) == 1 and text.count(new) == 1
        assert old not in text


def test_k8_split_operands_and_card(monkeypatch):
    from smqtk_indexing_tpu_torch.tools import pq_adc_split as k8
    db3c, s2t, lut, ti, c0, lo, hi = k8.operands(
        b=3, p=8, live=2, m=4, n_tiles=2, device="cpu")
    assert db3c.shape == (2, 4, 4096) and lut.shape == (3, 1024)
    assert ((hi > lo).sum(1) == 2).all()
    assert (c0 % 128 == 0).all() and (c0 + 640 <= 4096).all()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        k8.main([])
