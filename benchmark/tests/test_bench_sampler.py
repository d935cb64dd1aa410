"""The window's sample of answers: uniform over every answer offered, the
same for the same seed, and cheap whatever the batch."""
import collections

import pytest

from benchmark.sampler import Reservoir


def _fill(seed, batches, size=10, n=10):
    r = Reservoir(size, seed)
    for b in range(batches):
        r.offer(n, lambda j, b=b: b * n + j)
    return r


def test_the_sample_is_uniform_over_all_items():
    counts = collections.Counter()
    for seed in range(2000):
        counts.update(_fill(seed, 10).items)
    # 2,000 draws of 10 of 100 items: 200 each on average.
    assert all(140 <= counts[i] <= 260 for i in range(100)), counts


def test_the_same_seed_gives_the_same_sample():
    assert _fill(7, 30).items == _fill(7, 30).items
    assert _fill(7, 30).items != _fill(8, 30).items
    assert _fill(7, 30).seen == 300


def test_a_short_stream_is_kept_whole():
    r = Reservoir(5, 1)
    r.offer(3, lambda j: j)
    assert r.items == [0, 1, 2]


def test_items_are_built_only_when_taken():
    built = []
    r = Reservoir(4, 3)
    for b in range(1000):
        r.offer(1024, lambda j, b=b: built.append((b, j)) or (b, j))
    # About size * (1 + ln(N / size)) of a million offered.
    assert len(built) < 200
    assert len(set(r.items)) == 4


def test_an_empty_reservoir_is_refused():
    with pytest.raises(ValueError):
        Reservoir(0, 1)
