"""
The port's bench (``smqtk_indexing_tpu_torch/bench.py``, ``bench_all.py``)
against the repository's ``bench.py`` and ``bench_all.py``: the recipes
and the ground truth byte for byte, the ``$SMQTK_TPU_DATA`` branch on the
committed fixtures, and every section and both headline lines run small on
the CPU, each line under its JAX name with the prefix ``torch_`` and with
the JAX line's keys (read from the JAX scripts' source).
"""
import ast
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from threadpoolctl import threadpool_limits

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import bench_all as jax_bench_all  # noqa: E402
from smqtk_indexing_tpu_torch import bench, bench_all  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _one_blas_thread():
    """numpy's BLAS on one thread too: the OPQ training here is many small
    products, which BLAS threads slow several-fold on a loaded machine."""
    with threadpool_limits(1):
        yield

DATA = os.path.join(ROOT, "tests", "data")

#: Sizes that run every section in a few seconds on one thread.
SMALL = {"itq": dict(n=2048, fit_rows=1024, b=64, pools=(64, 256)),
         "lsh_e2e": dict(n=2048, nq_large=64, fit_rows=1024),
         "ivf": dict(n=512, n_lists=4, nq_large=16, nprobes=(2,)),
         "mrpt": dict(n=1024, d=64, configs=((2, 3),)),
         "sq8": dict(n=2048)}


def _jax_lines(path: str) -> list:
    """(metric-name regex, required keys) of every JSON line a JAX bench
    script prints: its ``emit(metric=..., **keys)`` calls and the
    ``json.dumps({"metric": ...})`` dicts, from its source."""
    tree = ast.parse(open(path).read())
    out = []

    def pattern(node):
        if isinstance(node, ast.Constant):
            return re.escape(node.value)
        return "".join(re.escape(v.value) if isinstance(v, ast.Constant)
                       else ".*?" for v in node.values)

    for node in ast.walk(tree):
        if isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "emit":
            kw = {k.arg: k.value for k in node.keywords}
            out.append((pattern(kw.pop("metric")),
                        {k for k in kw if k is not None} | {"metric"}))
        if isinstance(node, ast.Dict) and any(
                isinstance(k, ast.Constant) and k.value == "metric"
                for k in node.keys):
            keys = {k.value for k in node.keys}
            metric = node.values[[k.value for k in node.keys]
                                 .index("metric")]
            out.append((pattern(metric), keys))
    return out


JAX_BENCH_ALL = _jax_lines(os.path.join(ROOT, "bench_all.py"))
JAX_BENCH = _jax_lines(os.path.join(ROOT, "bench.py"))


def _check_lines(text: str, jax_lines) -> list:
    """Each JSON line's metric is ``torch_`` + a JAX metric, and it holds
    that JAX line's keys; returns the parsed lines."""
    lines = [json.loads(ln) for ln in text.splitlines()
             if ln.startswith("{")]
    assert lines
    for line in lines:
        name = line["metric"]
        assert name.startswith("torch_"), name
        keys = [k for pat, k in jax_lines
                if re.fullmatch(pat, name[len("torch_"):])]
        assert keys, f"{name} has no JAX counterpart"
        assert keys[0] <= set(line), (name, keys[0] - set(line))
    return lines


@pytest.mark.parametrize("rank", [None, 8])
def test_load_or_make_is_bench_alls(monkeypatch, rank):
    monkeypatch.setenv("SMQTK_TPU_DATA", "")
    args = ("deep_base.fvecs", 3000, 48, 218.0)
    kw = dict(seed=2, nq=70, rank=rank)
    port = bench_all._load_or_make(*args, **kw)
    ref = jax_bench_all._load_or_make(*args, **kw)
    assert port[2] == ref[2]
    for a, b in zip(port[:2], ref[:2]):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_load_or_make_chunks_the_noise_as_one_draw(monkeypatch):
    # More rows than one noise chunk: the chunked draws are one draw.
    monkeypatch.setattr(bench_all, "_NOISE_ROWS", 1000)
    port = bench_all._load_or_make("x.fvecs", 2500, 16, 1.0, seed=4)
    ref = jax_bench_all._load_or_make("x.fvecs", 2500, 16, 1.0, seed=4)
    assert port[0].tobytes() == ref[0].tobytes()
    assert port[1].tobytes() == ref[1].tobytes()


def test_ground_truth_and_recall_are_bench_alls():
    db, q, _ = bench_all._load_or_make("x.fvecs", 5000, 32, 1.0, seed=1,
                                       nq=16)
    port = bench_all._exact_ground_truth(db, q, chunk=1500)
    ref = jax_bench_all._exact_ground_truth(db, q, chunk=1500)
    np.testing.assert_array_equal(port, ref)
    got = ref[:, ::-1][:, 2:12]
    assert bench_all._recall_at_10(got, ref) \
        == jax_bench_all._recall_at_10(got, ref)


@pytest.mark.parametrize("no_native", [False, True])
@pytest.mark.parametrize("name", ["tiny_base.fvecs", "tiny_base.bvecs"])
def test_real_corpus_branch_is_bench_alls(monkeypatch, name, no_native):
    import smqtk_indexing_tpu.native as jax_native
    import smqtk_indexing_tpu_torch.native as native
    if no_native:
        monkeypatch.setenv("SMQTK_TPU_NO_NATIVE", "1")
    for mod in (native, jax_native):
        monkeypatch.setattr(mod, "_lib", None)
        monkeypatch.setattr(mod, "_tried", False)
    monkeypatch.setenv("SMQTK_TPU_DATA", DATA)
    port = bench_all._load_or_make(name, 64, 16, 1.0, seed=0, nq=8)
    ref = jax_bench_all._load_or_make(name, 64, 16, 1.0, seed=0, nq=8)
    assert port[2] == ref[2] == name
    np.testing.assert_array_equal(port[0], ref[0])
    np.testing.assert_array_equal(port[1], ref[1])
    # A rank-controlled recipe never reads the corpus.
    assert bench_all._load_or_make(name, 64, 16, 1.0, seed=0, nq=8,
                                   rank=4)[2] == "synthetic-rank4"


def test_serving_recipe_is_bench_pys_and_not_bench_alls():
    # bench.py:183-190 at a small n, written out as bench.py has it.
    rng = np.random.default_rng(2)
    n, total = 3000, 3000 + 64
    centers = rng.random((1024, 96), dtype=np.float32)
    pts = centers[rng.integers(0, 1024, size=total)]
    pts += rng.normal(size=(total, 96)).astype(np.float32) / 12
    pts = np.clip(pts, 0, 1).astype(np.float32)[rng.permutation(total)]
    db, q = bench.serving_data(n, 96, 64)
    assert db.tobytes() == pts[:n].tobytes()
    assert q.tobytes() == pts[n:].tobytes()
    other = bench_all._load_or_make("x.fvecs", n, 96, 1.0, seed=2, nq=64)
    assert not np.array_equal(db, other[0])


@pytest.mark.parametrize("name", list(bench_all.sections("cpu")))
def test_each_section_runs_small(capsys, monkeypatch, name):
    monkeypatch.setenv("SMQTK_TPU_DATA", "")
    bench_all.sections("cpu", SMALL)[name]()
    lines = _check_lines(capsys.readouterr().out, JAX_BENCH_ALL)
    for line in lines:
        assert line.get("dataset", "synthetic").startswith("synthetic")
        if "recall_at_10" in line:
            assert 0.0 <= line["recall_at_10"] <= 1.0
    if name == "sq8":
        assert lines[0]["fused_stage1"] is False     # the CPU's routing


def test_main_picks_sections_as_bench_all(capsys, monkeypatch):
    ran = []
    monkeypatch.setattr(bench_all, "sections", lambda device: {
        s: (lambda s=s: ran.append(s)) for s in
        ("itq", "lsh_e2e", "ivf", "mrpt", "sq8", "ivf_code", "ivf_code_pq",
         "ivf_corr")})
    bench_all.main(["--device", "cpu"])
    assert ran == ["itq", "lsh_e2e", "ivf", "mrpt", "sq8", "ivf_code",
                   "ivf_code_pq"]
    ran.clear()
    bench_all.main(["ivf_corr", "nonsense", "--device", "cpu"])
    assert ran == ["ivf_corr"]
    lines = _check_lines(capsys.readouterr().out, JAX_BENCH_ALL)
    assert lines[-2]["sections"] == ["ivf_corr"]


def test_bench_lines_run_small(capsys):
    host = bench.flat_line("cpu", n=2048, batch=32, iters=2)
    bench.serving_line(host * 2048, "cpu", n=2048, n_lists=8, batch=32)
    flat, serving = _check_lines(capsys.readouterr().out, JAX_BENCH)
    assert flat["metric"] == "torch_sift1m_flat_l2_knn_qps_b2048_bestof3"
    assert flat["recall_at_10"] == 1.0 and flat["stage1"] == "plain"
    assert serving["metric"] \
        == "torch_deep1m_ivf4096_sq8_code_score_np4_b1024_qps"
    assert serving["recall_bar"] == 0.9672
    assert 0.0 < serving["recall_at_10"] <= 1.0


def test_the_card_is_the_default():
    # No card here: a tool run with its defaults fails, and does not fall
    # back to the CPU.
    with pytest.raises(RuntimeError, match="is_available"):
        bench.flat_line(n=4096, batch=64)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_all.bench_sq8(n=2048)
