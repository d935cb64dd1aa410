"""The order statistics and the window metrics built on them."""
import json
import statistics
from types import SimpleNamespace

import pytest

from benchmark import registry
from benchmark.stats import percentile, spread


def test_percentile_is_the_nearest_rank():
    values = list(range(1, 101))                 # 1 .. 100
    assert percentile(values, 95) == 95
    assert percentile(values, 100) == 100
    assert percentile(list(reversed(values)), 50) == 50
    assert percentile([7.0], 95) == 7.0
    # 20 values: the 19th is the smallest with 95% at or below it.
    assert percentile(list(range(20)), 95) == 18


@pytest.mark.parametrize("bad", [0, -1, 101])
def test_percentile_rejects_a_share_outside_0_100(bad):
    with pytest.raises(ValueError):
        percentile([1.0, 2.0], bad)


def test_percentile_of_nothing_raises():
    with pytest.raises(ValueError):
        percentile([], 95)


def test_spread_is_the_quartile_gap_over_the_median():
    values = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(values, n=4)
    assert spread(values) == pytest.approx((q3 - q1) / 12.5)


def _run(durations, seconds, failed=0):
    calls, t = [], 0.0
    for d in durations:
        calls.append((t, t + d, 100))
        t += d
    return SimpleNamespace(calls=calls, seconds=seconds, failed=failed)


def test_qps_counts_every_query_of_the_window_over_its_length():
    qps = registry.load_module("metrics", "qps").read
    run = _run([0.1] * 95, 10.0)
    assert qps(run) == pytest.approx(95 * 100 / 10.0)
    # Queries of calls that failed are not answered.
    assert qps(_run([0.1] * 95, 10.0, failed=100)) == pytest.approx(
        94 * 100 / 10.0)


@pytest.mark.parametrize("name", ["batch_p95_ms", "batch_p95_ms.deep10m"])
def test_batch_p95_is_taken_over_all_calls(name):
    read = registry.load_module("metrics", name).read
    # 100 calls of 10..109 ms in a shuffled order: the 95th is 104 ms.
    durations = [(10 + (37 * i) % 100) / 1e3 for i in range(100)]
    assert read(_run(durations, 20.0)) == pytest.approx(104.0)
    assert read(_run([], 20.0)) is None


def test_spreads_reads_sets_of_result_lines(tmp_path):
    from benchmark import spreads
    paths = []
    for k, values in enumerate(([100, 101, 102, 103, 104, 105],
                                [100, 100, 100, 100, 100, 130])):
        p = tmp_path / f"set{k}.jsonl"
        p.write_text("noise\n" + "".join(
            json.dumps({"metrics": {"qps": {"value": v, "unit": "q/s"},
                                    "setup_s": {"value": 20.0,
                                                "unit": "s"}}}) + "\n"
            for v in values))
        paths.append(str(p))
    rows = spreads.report(paths)
    assert rows["qps"]["widest"] == pytest.approx(
        max(spread([100, 101, 102, 103, 104, 105]),
            spread([100, 100, 100, 100, 100, 130])))
    assert rows["qps"]["bound"] == pytest.approx(5 * rows["qps"]["widest"])
    assert rows["setup_s"]["bound"] == 0.01
