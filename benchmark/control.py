"""
The control of a cell's check: the plain reference put in the program's
place in the nearest precision below the one the configuration states
(``references/<reference>.control``), judged by the same comparison as a
run's answers. It has to come out as not correct.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3

On the card, at the cell's own size: for each seed it makes the cell's
configuration rows and its traffic's query pool as a run does, draws the
check's sample of queries from the seed, answers them with the traffic's
k, and prints one JSON line: the compared numbers, their limits, and
whether they pass. The benchmark's own runs do not run it.
"""
from __future__ import annotations

import argparse
import json
import random
import sys
from typing import Optional, Sequence


from benchmark import registry


def control_numbers(config: dict, traffic: dict, seed: int,
                    device: str) -> dict:
    """The compared numbers of the control's answers for ``seed``, with
    the pool size and k of ``traffic``."""
    recipe = registry.load_module("recipes", config["data"]["recipe"])
    reference = registry.load_module("references",
                                     config["check"]["reference"])
    pool_size, k = int(traffic["pool"]), int(traffic["k"])
    rows, pool = recipe.make(config["data"], pool_size, seed, device)
    picks = random.Random(seed).sample(range(pool_size),
                                       int(config["check"]["sample"]))
    got = reference.control(rows, pool[picks], k, device)
    answers = [(p, ids, dists) for p, (ids, dists) in zip(picks, got)]
    return reference.compare(answers, rows, pool, k, device)


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = registry.cell(registry.load_spec(), args.workload)
    config = registry.load_json("configs", cell["config"])
    traffic = registry.load_json("traffic", cell["traffic"])
    limits = config["check"]["limits"]

    import torch
    if not torch.cuda.is_available():
        print("the control runs on a CUDA card; found none",
              file=sys.stderr)
        return 2
    for seed in args.seeds:
        got = control_numbers(config, traffic, seed, "cuda")
        passed = all(got[n] <= lim for n, lim in limits.items())
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "numbers": got, "limits": limits,
                          "control_passes": passed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
