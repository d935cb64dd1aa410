"""Host ms a call in stacking the query batch's vectors (the program's
``flat.stack`` span in ``FlatNearestNeighborsIndex._nn_many``), over the
window. Host-only work, so the host clock is right."""
from benchmark.spans import ms_a_call


def read(run):
    return ms_a_call(run, "flat.stack")
