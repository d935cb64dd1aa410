"""Host ms a call in the vector store's query upload (the program's
``store.upload`` span inside ``store.knn``: the query's pad and its copy
to the card), over the window."""
from benchmark.spans import ms_a_call


def read(run):
    return ms_a_call(run, "store.upload")
