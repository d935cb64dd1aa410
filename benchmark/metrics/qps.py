"""Queries answered a second: the queries of the ``nn_many`` calls that
ended inside the window, less those of calls that failed, over the
window's seconds."""


def read(run):
    return (sum(c[2] for c in run.calls) - run.failed) / run.seconds
