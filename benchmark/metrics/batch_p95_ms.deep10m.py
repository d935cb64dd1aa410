"""``batch_p95_ms`` read in the traced run of the Deep10M cell, where the
host's collection stalls may set the tail (so it is no end-to-end metric
there): the 95th percentile (nearest rank) of the host-clock time of
every ``nn_many`` call that ended inside the window, in ms."""
from benchmark import registry


def read(run):
    return registry.load_module("metrics", "batch_p95_ms").read(run)
