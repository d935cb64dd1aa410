"""Stage 1 of the exact flat scan against its roofline, in %: the bound
of ``peaks.flat_stage1`` (the live rows, the batch's queries and the
minima, each once; 2 B N d operations at the bf16 tensor rate) over the
device time a call of the operations launched inside the program's
``fused_scan.stage1`` range (K1 ``segment_minima`` and the selection),
from the traced stretch."""
from benchmark.peaks import flat_stage1

RANGE = "fused_scan.stage1"


def read(run):
    tl = run.timeline
    if tl is None or not tl.calls or not tl.device_s.get(RANGE):
        return None
    bound, _ = flat_stage1(int(run.traffic["batch"]),
                           int(run.config["data"]["n"]),
                           int(run.config["data"]["dim"]))
    return 100.0 * bound / (tl.device_s[RANGE] / tl.calls)
