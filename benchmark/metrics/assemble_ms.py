"""Host ms a call in the flat index's result assembly (the program's
``flat.assemble`` span: uid lists to descriptor elements and distance
tuples), over the window. Host-only work, so the host clock is right."""


def read(run):
    calls = run.counters.get("span.flat.assemble.calls", 0.0)
    if not calls:
        return None
    return 1e3 * run.counters["span.flat.assemble.seconds"] / calls
