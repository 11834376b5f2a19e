"""Training metrics, copied from ``fdgan_tpu/train/meters.py``: the
reference's ``AverageMeter`` (misc.py:121-136), a JSONL step logger and
``create_exp_dir`` (misc.py:7-13)."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Optional


class AverageMeter:
    """Running mean."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class MetricLogger:
    """Per-step metrics to stdout and an optional JSONL file."""

    def __init__(self, log_path: Optional[str] = None, print_every: int = 10):
        self.log_path = log_path
        self.print_every = print_every
        self._fh = None
        if log_path:
            os.makedirs(os.path.dirname(log_path) or ".", exist_ok=True)
            self._fh = open(log_path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict):
        rec = {"step": step, "t": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if hasattr(v, "__float__") else v) for k, v in metrics.items()})
        if self._fh:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in rec.items())
            print(parts, file=sys.stdout, flush=True)

    def close(self):
        if self._fh:
            self._fh.close()


def create_exp_dir(exp: str) -> bool:
    """``misc.create_exp_dir`` (misc.py:7-13): make ``exp`` and say so, or
    leave an existing one as it is."""
    try:
        os.makedirs(exp)
        print(f"Creating exp dir: {exp}")
    except OSError:
        pass
    return True
