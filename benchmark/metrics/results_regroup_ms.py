"""Host ms a call in the result assembly's regrouping (the program's
``results.regroup`` span inside ``flat.assemble``: the distances listed
and each query's element and distance tuples built), over the window.
Host-only work, so the host clock is right."""
from benchmark.spans import ms_a_call


def read(run):
    return ms_a_call(run, "results.regroup")
