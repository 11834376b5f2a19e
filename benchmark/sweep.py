#!/usr/bin/env python3
"""Find an open-loop cell's knee once, on a GPU machine: the highest offered
rate at which completions keep pace with arrivals.

    python3 benchmark/sweep.py --workload fdgan.serve.poisson --seed 1 --seconds 10 --rates 100 150 200

Builds the cell's program once, then offers each rate for ``--seconds`` and
prints, per rate, what was offered and completed by the window's close, the
latency percentiles from due times, the images per batch and the
generator's lateness. At a rate the system sustains nearly every request
completes by the close and the tail stays flat from rate to rate; above
it the backlog grows through the window.
"""

import json
import sys

import run  # noqa: F401  (the checkout on the path, the caches inside it)


def main(argv=None) -> int:
    import argparse

    import torch

    from harness import cells
    from harness.specs import Specs

    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--rates", type=float, nargs="+", required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep needs a CUDA device", file=sys.stderr)
        return 2
    specs = Specs(run.ROOT)
    cell = specs.workload(args.workload)
    config, mix = specs.config(cell["config"]), specs.traffic(cell["traffic"])
    with cells.driver(config, mix, args.seed, torch.device("cuda"), specs.family) as drv:
        drv.setup()
        for rate in args.rates:
            w = drv.window(args.seconds, rate)
            keys = ("rate", "offered", "completed_by_close", "latency_p50_ms", "latency_p95_ms", "late_p95_ms",
                    "late_max_ms", "window_s")
            row = {k: w[k] for k in keys}
            row["batch_mean"] = w["batch_images"] / max(1, w["batches"])
            row["failed"] = drv.failed
            print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
