"""
The IVF list-scan tools on the CPU: ``tools/ivf_times.py`` (K6 and K7
beside another checkout's) and ``tools/ivf_scan_split.py`` (their
knock-out splits). Each knock-out still finds its text in the current
kernels' sources, the split picks the knock-outs of the design a source
holds, the times tool builds each kernel's operands as the index's query
does and passes them in the C entry point's order, and both tools refuse
to run without a card.
"""
import numpy as np
import pytest
import torch

from smqtk_indexing_tpu_torch.ops import _kernels, ivf_scan
from smqtk_indexing_tpu_torch.tools import ivf_scan_split as split
from smqtk_indexing_tpu_torch.tools import ivf_times
from smqtk_indexing_tpu_torch.tools.tiled_wgmma_split import variant_source

torch.set_num_threads(1)

CASES = [(kernel, name) for kernel, designs in split.KNOCKOUTS.items()
         for name in designs["runs"]]


@pytest.mark.parametrize("kernel,name", CASES)
def test_each_knockout_applies_once(kernel, name):
    source = ivf_times.SOURCES[kernel][0]
    design, table = split.knockouts(kernel)
    assert design == "runs"
    full = (_kernels.CSRC / source).read_text()
    text = variant_source(name, source, table)
    if name == "full":
        assert text == full
        return
    assert text != full
    for old, _ in table[name]:
        assert full.count(old) == 1


@pytest.mark.parametrize("kernel", list(split.KNOCKOUTS))
def test_knockouts_follow_the_design_a_source_holds(kernel, tmp_path):
    # A source holding the first design's texts (an older checkout's)
    # takes the first table; one holding neither is refused.
    source = ivf_times.SOURCES[kernel][0]
    first = split.KNOCKOUTS[kernel]["first"]
    (tmp_path / source).write_text("\n".join(
        old for pairs in first.values() for old, _ in pairs))
    assert split.knockouts(kernel, tmp_path) == ("first", first)
    (tmp_path / source).write_text("// another kernel\n")
    with pytest.raises(ValueError, match="no knock-out table"):
        split.knockouts(kernel, tmp_path)


@pytest.mark.parametrize("tool", [ivf_times, split])
def test_tools_need_a_card(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        tool.main([])


def test_operands_and_launch_arguments(monkeypatch):
    # Each index's kernel operands as its query makes them, at the serving
    # nprobe and at nprobe = n_lists, passed in the C entry point's order.
    from smqtk_indexing_tpu_torch.data import DescriptorMemoryElement

    class _Stream:
        cuda_stream = 0
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _Stream())
    monkeypatch.setattr(ivf_times, "N_LISTS", 16)
    data, queries = ivf_times.ivf_data(n=3000, n_queries=6)
    elems = [DescriptorMemoryElement(i, data[i]) for i in range(len(data))]
    for name, (_, kernel) in ivf_times.INDEXES.items():
        index = ivf_times.build_index(name, elems, device="cpu")
        d_pad = index._centroids_np.shape[1]
        q_pad = torch.from_numpy(np.pad(queries, ((0, 0), (0, d_pad - 96))))
        for nprobe in (4, 16):
            args = ivf_times.operands(index, q_pad, nprobe)
            assert index.nprobe == 4
            lo, hi = args[-2:]
            assert lo.shape[0] == 6 and bool((hi >= lo).all())
            entry = ivf_times.entry_name(kernel, args)
            assert entry == {"code_sq8": "ivf_list_scores_tiled_i8",
                             "rows_f32": "ivf_list_scores_f32",
                             "rows_sq8": "ivf_list_scores_i8"}[name]
            # The kernel's wrapper (its plain version here) takes them.
            want = getattr(ivf_scan, kernel)(*args)
            got = []
            launch, out = ivf_times.launcher(
                lambda *xs: got.append(xs) or 0, kernel, args)
            assert launch() is out and out.shape == want.shape
            assert len(got[0]) == len(_kernels._ENTRY_POINTS[entry])
            sizes = got[0][-7:-2] if kernel == "ivf_list_scores_tiled" \
                else got[0][-6:-2]
            assert sizes[:2] == tuple(lo.shape)
            assert sizes[-1] == want.shape[2]


def test_entries_from_routes_only_the_named_entry_points(monkeypatch):
    class _Lib:
        ivf_list_scores_f32 = "this f32"
        ivf_list_scores_i8 = "this i8"
    monkeypatch.setattr(_kernels, "library", lambda: _Lib)
    with ivf_times.entries_from({"ivf_list_scores_f32": "other f32"}):
        assert _kernels.library().ivf_list_scores_f32 == "other f32"
        assert _kernels.library().ivf_list_scores_i8 == "this i8"
    assert _kernels.library().ivf_list_scores_f32 == "this f32"
    with ivf_times.entries_from(None):
        assert _kernels.library() is _Lib
