"""ms of garbage collection a call in the window, all generations, timed
by the harness's own ``gc.callbacks``."""


def read(run):
    if not run.calls:
        return None
    return 1e3 * sum(run.gc_seconds) / len(run.calls)
