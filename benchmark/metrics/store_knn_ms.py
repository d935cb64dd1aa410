"""ms a call in the vector store's query (the program's ``store.knn``
span: query upload, stage 1, stage 2, the copy back and the row-to-uid
mapping), over the window. The span ends in the copy back to the host, so
it holds the card's time too."""


def read(run):
    calls = run.counters.get("span.store.knn.calls", 0.0)
    if not calls:
        return None
    return 1e3 * run.counters["span.store.knn.seconds"] / calls
