"""95th percentile (nearest rank) of the host-clock time of every
``nn_many`` call that ended inside the window, until its results were
Python objects, in ms."""
from benchmark.stats import percentile


def read(run):
    if not run.calls:
        return None
    return 1e3 * percentile([t1 - t0 for t0, t1, _ in run.calls], 95)
