"""The control of each configuration's check, the reference in TF32 in
the program's place, comes out as not correct under the configuration's
limits; the reference's own numbers on its own answers are nought."""
import random

import numpy as np
import pytest
import torch

from benchmark import control, registry

CONFIGS = ["flat-f32-gist1m", "flat-f32-deep10m"]
SEEDS = [2 ** 31 + 5, 2 ** 31 + 6, 2 ** 31 + 7]


def _config(name, n):
    config = registry.load_json("configs", name)
    config["data"]["n"] = n
    return config


def _traffic(pool):
    return dict(registry.load_json("traffic", "closed-b1024"), pool=pool)


def _fails(config, got):
    return any(got[k] > lim for k, lim in config["check"]["limits"].items())


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", SEEDS)
def test_the_control_is_not_correct(name, seed):
    config = _config(name, 20_000)
    got = control.control_numbers(config, _traffic(1024), seed, "cpu")
    assert _fails(config, got), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_the_control_is_not_correct_on_the_card(card, name):
    config = _config(name, 1 << 20)
    for seed in SEEDS:
        got = control.control_numbers(config, _traffic(4096), seed,
                                       card)
        assert _fails(config, got), got


@pytest.mark.parametrize("name", CONFIGS)
def test_the_reference_passes_its_own_answers(name):
    config = _config(name, 5_000)
    ref = registry.load_module("references", "exact_knn")
    recipe = registry.load_module("recipes", "clustered")
    rows, pool = recipe.make(config["data"], 256, 11, "cpu")
    picks = random.Random(11).sample(range(256), 64)
    ids, d = ref.truth(rows, pool[picks], 10, "cpu")
    answers = [(p, i.tolist(), x.astype(np.float32).tolist())
               for p, i, x in zip(picks, ids, d)]
    got = ref.compare(answers, rows, pool, 10, "cpu")
    assert got["malformed"] == 0 and got["recall_at_10"] == 1.0
    assert got["rank_excess"] < 1e-12 and got["dist_err"] < 1e-7
    assert not _fails(config, got)


def test_the_control_needs_a_card(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert control.main(["--workload", "flat-gist1m.b16",
                         "--seeds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_tf32_rounding_keeps_ten_mantissa_bits():
    ref = registry.load_module("references", "exact_knn")
    x = torch.tensor([1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -11,
                      1.0 + 3 * 2 ** -11, 1.0 + 2 ** -12, -3.0])
    got = ref.to_tf32(x).tolist()
    # Ties go to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9.
    assert got == [1.0, 1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, 1.0, -3.0]


def test_malformed_answers_are_counted():
    ref = registry.load_module("references", "exact_knn")
    recipe = registry.load_module("recipes", "clustered")
    config = _config("flat-f32-deep10m", 2_000)
    rows, pool = recipe.make(config["data"], 16, 3, "cpu")
    ids, d = ref.truth(rows, pool[:4], 10, "cpu")
    good = (0, ids[0].tolist(), d[0].tolist())
    bad = [(1, None, None), (2, ids[2].tolist()[:9], d[2].tolist()[:9]),
           (3, [ids[3][0]] * 10, d[3].tolist()),
           (1, ids[1].tolist(), d[1].tolist()[::-1])]
    got = ref.compare([good] + bad, rows, pool, 10, "cpu")
    assert got["malformed"] == 4 and got["recall_at_10"] == 1.0
