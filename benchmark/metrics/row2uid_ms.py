"""Host ms a call in mapping the result rows to uids (the program's
``store.row2uid`` span inside ``store.knn``), over the window. Host-only
work, so the host clock is right."""
from benchmark.spans import ms_a_call


def read(run):
    return ms_a_call(run, "store.row2uid")
