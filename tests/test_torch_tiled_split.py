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
