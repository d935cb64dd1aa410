"""Share of the traced stretch in which no operation ran on the card, in
%, from the profiler's timeline."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0 or tl.busy_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
