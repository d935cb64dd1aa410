"""Host ms a call in the result assembly's descriptor lookup (the
program's ``results.fetch`` span inside ``flat.assemble``: the uid lists
flattened and their elements fetched), over the window. Host-only work,
so the host clock is right."""
from benchmark.spans import ms_a_call


def read(run):
    return ms_a_call(run, "results.fetch")
