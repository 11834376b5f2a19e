#!/usr/bin/env python3
"""The benchmark of ``fdgan_tpu_torch`` on NVIDIA GPUs: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Builds the cell's program from its
configuration and the seed, measures for ``--seconds`` seconds, checks what
the window produced against the plain reference, and prints one JSON line:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` (and a trace
``breakdown``), and ``checks``, each compared number beside its limit.
Exits non-zero, printing no result, without enough CUDA devices, and if JAX
or the JAX package was loaded.
"""

import os
import sys
import time
from pathlib import Path

T_START = time.time()
BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every build and kernel cache inside the checkout, at fixed paths
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _sub)
os.environ["USE_FLAX"] = "0"
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None) -> int:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from harness.runner import forbidden_modules, run_cell
    from harness.specs import Specs

    specs = Specs(ROOT)
    need = specs.workload(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(specs, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = forbidden_modules()
    if bad:
        print(f"JAX or the JAX package was loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
