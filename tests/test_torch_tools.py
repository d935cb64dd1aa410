"""
The port's measuring tools on the CPU at small sizes:
``tools/verify_exactness.py`` (each of the nine checks passes, and fails
when its answer is perturbed, so none is vacuous), ``tools/recall_ladder.py``
and ``tools/metric_ab.py`` (they run, and print the JAX tools' line
schemas, read from the JAX tools' source).
"""
import ast
import json
import os

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

from smqtk_indexing_tpu_torch.models.nn_index.ivf import (
    IvfNearestNeighborsIndex,
)
from smqtk_indexing_tpu_torch.ops import fused_scan, pq, sq8
from smqtk_indexing_tpu_torch.tools import (
    metric_ab, recall_ladder, verify_exactness as ve,
)

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's BLAS on one thread too: the OPQ training here is many small
    products, which BLAS threads slow several-fold on a loaded machine."""
    with threadpool_limits(1):
        yield

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Rows of the CPU drive: every check, the PQ ones on all of them.
N_DRIVE = 2048


@pytest.fixture(scope="module")
def drive():
    return ve.Drive(N_DRIVE, "cpu")


@pytest.mark.parametrize("check", ve.CHECKS)
def test_check_passes_small(drive, check):
    out = getattr(ve, f"check_{check}")(drive)
    if check == 1:
        assert out == {mode: 0 for mode in ve.MODES}


def _swap_rows(result):
    dd, rr = result
    rr = rr.clone()
    rr[:, [0, 1]] = rr[:, [1, 0]]
    return dd, rr


def _shift_first(result):
    dd, rr = result
    dd = dd.clone()
    dd[0, 0] += 1.0
    return dd, rr


def _perturbed_nn_many(how, only_sharded=False):
    real = IvfNearestNeighborsIndex.nn_many

    def nn_many(self, elems, n=1):
        res = list(real(self, elems, n))
        if only_sharded and not self.n_devices:
            return res
        els, dists = (list(x) for x in res[0])
        if how == "swap":
            els[0], els[1] = els[1], els[0]
        else:                       # one distance far off its tolerance
            dists[0] = 2.0 * dists[0] + 1.0
        res[0] = (tuple(els), tuple(dists))
        return res
    return nn_many


#: Each check's perturbation: (object, attribute, replacement maker).
PERTURB = {
    1: (fused_scan, "flat_topk_fused", lambda f: lambda *a, **k:
        _swap_rows(f(*a, **k))),
    2: (IvfNearestNeighborsIndex, "nn_many",
        lambda f: _perturbed_nn_many("swap")),
    3: (sq8, "sq8_topk", lambda f: lambda *a, **k: _shift_first(f(*a, **k))),
    4: (pq, "pq_topk", lambda f: lambda *a, **k: _shift_first(f(*a, **k))),
    7: (IvfNearestNeighborsIndex, "nn_many",
        lambda f: _perturbed_nn_many("shift", only_sharded=True)),
    **{c: (IvfNearestNeighborsIndex, "nn_many",
           lambda f: _perturbed_nn_many("shift")) for c in (5, 6, 8, 9)},
}


@pytest.mark.parametrize("check", ve.CHECKS)
def test_check_fails_on_a_perturbed_answer(drive, monkeypatch, check):
    obj, name, make = PERTURB[check]
    monkeypatch.setattr(obj, name, make(getattr(obj, name)))
    with pytest.raises(AssertionError):
        getattr(ve, f"check_{check}")(drive)


def test_main_reports_each_check(monkeypatch, capsys):
    monkeypatch.setattr(ve, "check_3", lambda drv: None)

    def fail(drv):
        raise AssertionError("rows differ")
    monkeypatch.setattr(ve, "check_4", fail)
    assert ve.main([3, 4], n=1024, device="cpu") \
        == {3: "ok", 4: "FAILED: rows differ"}
    assert "failed [4]" in capsys.readouterr().out
    with pytest.raises(ValueError, match="unknown check"):
        ve.main([10], n=1024, device="cpu")


def _dumped_keys(path: str) -> list:
    """Key sets of the dict literals a JAX tool passes to ``json.dumps``."""
    tree = ast.parse(open(path).read())
    return [{k.value for k in node.args[0].keys}
            for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and getattr(node.func, "attr", "") == "dumps"
            and node.args and isinstance(node.args[0], ast.Dict)]


def _lines(text: str) -> list:
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_recall_ladder_runs_tiny(capsys):
    recall_ladder.main(300, 16, device="cpu", nprobes=(1, 2), nq=32)
    out = capsys.readouterr()
    schema = _dumped_keys(os.path.join(ROOT, "tools", "recall_ladder.py"))
    lines = _lines(out.out)
    n_codecs = len(recall_ladder.CODECS) + len(recall_ladder.COSINE_CODECS)
    assert len(lines) == 2 * n_codecs
    for line in lines:
        assert set(line) in schema
        assert line["dataset"] == "synthetic-rank8"
        assert 0.0 <= line["recall_at_10"] <= 1.0
    assert [ln["section"] for ln in lines] \
        == ["recall_ladder"] * 12 + ["recall_ladder_cosine"] * 8
    assert "| codec (bytes/vec) | np=1 | np=2 |" in out.err
    assert "| cosine codec (bytes/vec) | np=1 | np=2 |" in out.err
    f32 = [ln["recall_at_10"] for ln in lines if ln["codec"] == "f32"]
    assert f32 == sorted(f32)               # more probes, no less recall


def test_metric_ab_runs_tiny(capsys):
    lines = metric_ab.main("cpu", n=600, n_lists=8, nq_large=16,
                           nprobes=(8,))
    schema = _dumped_keys(os.path.join(ROOT, "tools", "metric_ab.py"))
    assert _lines(capsys.readouterr().out) == lines
    assert [ln["metric_axis"] for ln in lines] == list(metric_ab.METRICS)
    for line in lines:
        assert set(line) in schema
        # nprobe = n_lists: only the codec is lost.
        assert line["recall_at_10"] > 0.5
    assert np.isfinite([ln["qps_b1024"] for ln in lines]).all()
