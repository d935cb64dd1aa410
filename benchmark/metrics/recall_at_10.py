"""Recall@10 of the answers the window returned, against the float64
truth over the raw rows, on the seeded sample of them that the check
compares."""


def read(run):
    return run.check.get("recall_at_10")
