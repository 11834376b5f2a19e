#!/usr/bin/env python3
"""The readings that a cell's limits are set from, for one cell in one
process (a GPU machine):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 ... --control-seeds 1 2 3 [--seconds 3]

For each ``--seeds`` seed, one run of the program as ``run.py`` makes it, with
a short window (training needs none: its readings come from set-up's checked
steps), and the numbers ``correct`` compares: the lower readings. For each
``--control-seeds`` seed, the same numbers for the plain reference computed
in fp8 in the program's place: the upper readings; for each ``--fault-seeds``
seed (training), the reference with half of each batch left out. Prints a JSON line per
run and a summary of the largest program reading and the smallest control
reading of each number.
"""

import json
import sys
import time

import run  # noqa: F401  (the checkout on the path, the caches inside it)


def main(argv=None) -> int:
    import argparse

    import torch

    from harness import cells
    from harness.runner import run_cell
    from harness.specs import Specs

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--fault-seeds", type=int, nargs="*", default=[],
                   help="training: the reference with half of each batch left out, in the program's place")
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    specs = Specs(run.ROOT)
    cell = specs.workload(args.workload)
    config, mix = specs.config(cell["config"]), specs.traffic(cell["traffic"])
    low, high = {}, {}
    for seed in args.seeds:
        t = time.time()
        numbers = {}
        r = run_cell(specs, args.workload, seed, args.seconds, False, "cuda", numbers_out=numbers)
        for k, (v, _) in numbers.items():
            low.setdefault(k, []).append(float(v))
        print(json.dumps({"seed": seed, "side": "program", "s": time.time() - t, "correct": r["correct"],
                          "numbers": numbers, "metrics": r["metrics"]}), flush=True)
    for seed in args.control_seeds:
        t = time.time()
        with cells.driver(config, mix, seed, torch.device("cuda"), specs.family) as drv:
            numbers = drv.control(mix.get("check_images", mix.get("check_requests", 0)))
        for k, (v, _) in numbers.items():
            high.setdefault(k, []).append(float(v))
        print(json.dumps({"seed": seed, "side": "control", "s": time.time() - t,
                          "numbers": numbers}), flush=True)
    for seed in args.fault_seeds:
        with cells.driver(config, mix, seed, torch.device("cuda"), specs.family) as drv:
            numbers = drv.half_batch()
        print(json.dumps({"seed": seed, "side": "half_batch", "numbers": numbers}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": {k: max(v) for k, v in low.items()},
                      "control_min": {k: min(v) for k, v in high.items()}, "program": low, "control": high}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
