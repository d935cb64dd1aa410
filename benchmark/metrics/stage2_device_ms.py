"""Device ms a call of the operations launched inside the program's
``fused_scan.stage2`` range (``rerank_segments``: the gather of the kept
segments, the exact distances, the final top-k), from the traced
stretch."""

RANGE = "fused_scan.stage2"


def read(run):
    tl = run.timeline
    if tl is None or not tl.calls or not tl.device_s.get(RANGE):
        return None
    return 1e3 * tl.device_s[RANGE] / tl.calls
