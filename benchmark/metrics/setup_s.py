"""Seconds from the start of the harness to the start of the window:
imports, the rows and queries made from the seed, the index built through
its public API, the kernels built or loaded, and the warm-up calls."""


def read(run):
    return run.setup_s
