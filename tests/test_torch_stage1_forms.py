"""
Which stage-1 kernel form the launchers of
``smqtk_indexing_tpu_torch/ops/fused_scan.py`` record: the form of the C
entry point they call, from ``fused_scan._ENTRY_FORM``, with that table
held against the sources that define each entry point. The launchers run
here against a stand-in for the kernel library that records the entry
point called; the kernels themselves run on the card
(``tests/test_torch_cuda.py``).
"""
import contextlib
import re
import types
from pathlib import Path

import pytest
import torch

from smqtk_indexing_tpu_torch.ops import _kernels, fused_scan

CSRC = Path(fused_scan.__file__).resolve().parents[1] / "csrc"
#: The sources whose entry points run the products on the tensor cores.
WGMMA_SOURCES = {"segment_minima_wgmma.cu", "segment_minima_tiled_wgmma.cu"}


def _defined_entries() -> dict:
    """Every ``extern "C"`` entry point of ``csrc/*.cu``, with the file
    that defines it, expanding the macros that stamp them out."""
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        text = path.read_text()
        names = re.findall(r'^extern "C" int (\w+)\(', text, re.M)
        for macro, body in re.findall(
                r"^#define (\w+)\(NAME[^)]*\)(.*?)(?:\n\n|\Z)", text,
                re.M | re.S):
            stems = re.findall(r'extern "C" int (\w+)_##NAME\(', body)
            for arg in re.findall(rf"^{macro}\((\w+),", text, re.M):
                names += [f"{stem}_{arg}" for stem in stems]
        for name in names:
            found.setdefault(name, []).append(path.name)
    return found


@pytest.mark.parametrize("entry", sorted(fused_scan._ENTRY_FORM))
def test_entry_form_follows_the_source_that_defines_it(entry):
    files = _defined_entries().get(entry, [])
    assert len(files) == 1, f"{entry} defined in {files}"
    assert entry in _kernels._ENTRY_POINTS
    # An int8 query runs wgmma s8 in the tensor-core sources; an f32
    # database split to bf16 on the tensor cores names its precision.
    int8_query = entry.endswith("_i8i8")
    if files[0] in WGMMA_SOURCES:
        want = "wgmma_s8" if int8_query else "wgmma"
        for precision in ("split3", "native"):
            if entry.endswith(f"_f32_{precision}"):
                want = f"wgmma_{precision}"
    else:
        want = "i8i8" if int8_query else "ffma"
    assert fused_scan._ENTRY_FORM[entry] == want


def test_only_k9_keeps_the_dp4a_form():
    # The __dp4a form was K9's variant probe alone; K9 now runs the
    # tensor-core kernel of K2, K4 and K5, so no entry point, launch count
    # or source keeps __dp4a, and K9's int8 query runs wgmma s8.
    assert "i8i8" not in fused_scan._ENTRY_FORM.values()
    assert fused_scan._ENTRY_FORM["stage1_variant_i8i8"] == "wgmma_s8"
    assert fused_scan._ENTRY_FORM["stage1_variant_i8"] == "wgmma"
    assert {f for _, f in fused_scan.LAUNCHES} == {
        "ffma", "wgmma", "wgmma_s8", "wgmma_split3", "wgmma_native", "copy",
        "f32", "bf16"}
    for path in CSRC.glob("*.cu*"):
        assert "__dp4a" not in path.read_text(), path.name
    assert not (CSRC / "stage1_variants.cu").exists()
    src = (CSRC / "segment_minima.cu").read_text()
    assert "i8i8" not in src


def test_every_stage1_entry_has_a_form():
    stage1 = {name for name in _defined_entries()
              if name.startswith(("segment_minima", "stage1_variant"))}
    assert stage1 == set(fused_scan._ENTRY_FORM)


class _Library:
    """Stands in for the kernel library: records each entry point called
    and reports success."""

    def __init__(self):
        self.called = []

    def __getattr__(self, name):
        def entry(*args):
            self.called.append(name)
            return 0
        return entry


@pytest.fixture
def fake_card(monkeypatch):
    lib = _Library()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))
    # The wrappers launch inside the operands' card's device guard.
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    operands = []
    real = fused_scan._query_operand

    def spy(q, db_dtype, form):
        qk = real(q, db_dtype, form)
        operands.append(qk)
        return qk
    monkeypatch.setattr(fused_scan, "_query_operand", spy)
    return lib, operands


@pytest.mark.parametrize("db_dtype, q_dtype, bw, variant, entry", [
    (torch.int8, torch.float32, 1, None, "segment_minima_tiled_i8"),
    (torch.int8, torch.float32, 16, None, "segment_minima_tiled2_i8"),
    (torch.int8, torch.int8, 1, None, "segment_minima_tiled_i8i8"),
    (torch.int8, torch.int8, 16, None, "segment_minima_tiled2_i8i8"),
    (torch.float32, torch.float32, 1, None, "segment_minima_tiled_f32"),
    (torch.bfloat16, torch.float32, 16, None, "segment_minima_tiled2_bf16"),
    (torch.int8, torch.float32, 1, 0, "stage1_variant_i8"),
    (torch.int8, torch.int8, 1, 0, "stage1_variant_i8i8"),
])
def test_tiled_cuda_reports_the_form_it_launched(fake_card, db_dtype,
                                                 q_dtype, bw, variant,
                                                 entry):
    lib, operands = fake_card
    n_tiles, d, tile_n, b = 2, 64, 1024, 3
    db3 = torch.zeros((n_tiles, d, tile_n), dtype=db_dtype)
    vec = torch.zeros(n_tiles * tile_n)
    q = torch.ones((b, d), dtype=q_dtype)
    g = n_tiles * tile_n // fused_scan.SEG if bw == 1 else 16
    out, groups, form = fused_scan.tiled_cuda(db3, vec, vec, q, g, bw,
                                              variant=variant)
    assert lib.called == [entry]
    assert form == fused_scan._ENTRY_FORM[entry]
    # The query goes to the kernel in its form's operand type.
    want = {"wgmma": torch.bfloat16, "wgmma_s8": torch.int8,
            "i8i8": torch.int8, "ffma": torch.float32}[form]
    assert [qk.dtype for qk in operands] == [want]
    assert out.shape == (n_tiles * tile_n // fused_scan.SEG // g, b, g)
    assert (groups is None) == (bw == 1)


def test_k1_takes_an_int8_query_at_d_a_multiple_of_32(fake_card):
    # The int8 x int8 form zero-fills a K-chunk's tail, so d % 32 will do;
    # the other forms keep whole 128-dim chunks.
    lib, operands = fake_card
    vec = torch.zeros(256)
    out = fused_scan._segment_minima_cuda(
        torch.zeros((256, 96), dtype=torch.int8), vec, vec,
        torch.ones((3, 96), dtype=torch.int8))
    assert lib.called == ["segment_minima_i8i8"] and out.shape == (3, 2)
    assert [qk.dtype for qk in operands] == [torch.int8]
    for db_dtype, q_dtype, d in ((torch.int8, torch.int8, 48),
                                 (torch.int8, torch.float32, 96),
                                 (torch.bfloat16, torch.float32, 96)):
        with pytest.raises(ValueError, match="multiple of"):
            fused_scan._segment_minima_cuda(
                torch.zeros((256, d), dtype=db_dtype), vec, vec,
                torch.ones((3, d), dtype=q_dtype))
    assert lib.called == ["segment_minima_i8i8"]


@pytest.mark.parametrize("db_dtype, q_dtype, precision, form, q_shape", [
    (torch.float32, torch.float32, "highest", "ffma", (2, 128)),
    (torch.float32, torch.float32, "split3", "wgmma_split3", (2, 2, 128)),
    (torch.float32, torch.float32, "native", "wgmma_native", (2, 128)),
    (torch.bfloat16, torch.float32, "split3", "wgmma", (2, 128)),
    (torch.int8, torch.float32, "highest", "wgmma", (2, 128)),
    (torch.int8, torch.int8, "split3", "wgmma_s8", (2, 128)),
])
def test_segment_minima_counts_the_form_it_launched(fake_card, db_dtype,
                                                    q_dtype, precision,
                                                    form, q_shape):
    # An f32 database takes the precision's entry point; the other
    # databases ignore it. The query reaches the kernel in the form's
    # operand: split3's hi and lo parts stacked, (2, B, d).
    lib, operands = fake_card
    db = torch.zeros((256, 128), dtype=db_dtype)
    vec = torch.zeros(256)
    before = dict(fused_scan.LAUNCHES)
    fused_scan._segment_minima_cuda(db, vec, vec,
                                    torch.ones((2, 128), dtype=q_dtype),
                                    precision)
    (qk,) = operands
    assert tuple(qk.shape) == q_shape and qk.is_contiguous()
    assert fused_scan._ENTRY_FORM[lib.called[0]] == form
    grew = {k: n - before[k] for k, n in fused_scan.LAUNCHES.items()
            if n != before[k]}
    fused_scan.LAUNCHES.update(before)
    assert grew == {("segment_minima", form): 1}
