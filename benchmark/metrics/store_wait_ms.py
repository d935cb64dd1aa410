"""Host ms a call in the vector store's copy back (the program's
``store.copy_back`` span inside ``store.knn``: the host's wait for the
card's stages 1 and 2, then the copies of the distances and rows), over
the window."""
from benchmark.spans import ms_a_call


def read(run):
    return ms_a_call(run, "store.copy_back")
