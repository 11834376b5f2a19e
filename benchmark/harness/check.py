"""The numbers that decide ``correct``: what the timed path produced, against
the plain reference.

Images (``harness/cells.py``): each sampled answer's RMS gap in uint8 levels
to the reference's unrounded image, over the gap of the reference computed
with bf16 operands; and the answers that never came. Training: over the
first three steps, each step's G and D losses, the gradient each Adam got
at the first step (read back from the program's Adam state: after one step
its first moment is (1 − β1)·g), each parameter's change after the three
steps, and that of each running statistic the reference moved: per leaf
the gap between the program's norm and the reference's, over the larger
of the reference's norm of that leaf and of the median leaf, taken at the
worst leaf and at the median one. Which of these are compared, and
against what, is each cell's ``limits/<cell>.json``.
"""

from __future__ import annotations

import statistics
from typing import Dict, Optional, Tuple

import torch

# a leaf whose reference gradient is under this share of the median leaf's
# moves under Adam by round-off alone, and is left out of the change
ROUNDOFF_SHARE = 1e-3


def image_gap(program: torch.Tensor, ref_levels: torch.Tensor) -> float:
    """RMS of (program's uint8 levels − the reference's unrounded levels)."""
    if tuple(program.shape) != tuple(ref_levels.shape):
        return float("inf")
    return float((program.double() - ref_levels.double()).square().mean().sqrt())


def quantise(y: torch.Tensor) -> torch.Tensor:
    """A tanh output as the engine returns uint8: round((y + 1)·127.5) in
    fp32, clamped to [0, 255]."""
    return torch.clamp(torch.round((y.float() + 1.0) * 127.5), 0.0, 255.0).to(torch.uint8)


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(v.double().norm()) for k, v in leaves.items()}


def leaf_gaps(program: Dict[str, torch.Tensor], reference: Dict[str, torch.Tensor],
              keep: Optional[set] = None) -> Dict[str, float]:
    """Per leaf |‖p‖ − ‖r‖| / max(‖r‖, median leaf's ‖r‖); only the leaves
    in ``keep`` where given."""
    rn, pn = _norms(reference), _norms(program)
    keys = [k for k in reference if keep is None or k in keep]
    if not keys:
        return {}
    med = statistics.median(rn[k] for k in keys)
    return {k: abs(pn.get(k, 0.0) - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """The largest gap and its leaf (NaN counts as largest)."""
    if not gaps:
        return float("inf"), "no leaves"
    k = max(gaps, key=lambda n: float("inf") if gaps[n] != gaps[n] else gaps[n])
    return gaps[k], k


def moved_leaves(first_grads: Dict[str, torch.Tensor]) -> set:
    """The leaves whose reference gradient is at least ROUNDOFF_SHARE of the
    median leaf's norm."""
    n = _norms(first_grads)
    med = statistics.median(n.values())
    return {k for k, v in n.items() if v >= ROUNDOFF_SHARE * med}


def live_stats(change: Dict[str, torch.Tensor]) -> set:
    """The running statistics that moved: G's, folded after each step (D's
    are never folded, and dead BNs' never move)."""
    return {k for k, v in change.items() if "running_" in k and bool(v.abs().max() > 0)}


def _median(gaps: Dict[str, float]) -> Tuple[float, str]:
    return (statistics.median(gaps.values()), "median leaf") if gaps else (float("inf"), "no leaves")


def train_numbers(prog: dict, ref: dict) -> Dict[str, Tuple[float, str]]:
    """``prog`` and ``ref`` each hold ``losses`` [(g, d)] per step,
    ``grads`` {"g": {...}, "d": {...}} of the first step and ``change``
    {"g": {...}, "d": {...}} (parameters and running statistics after the
    checked steps, less before). Returns each number with where it is worst
    (or the median leaf's, for ``.median``): ``grad_gap`` and ``change_gap``
    over the parameters, ``stats_gap`` over the running statistics that the
    reference moved."""
    out = {}
    gaps = [(abs(p - r) / max(abs(r), 1e-12), f"step {i + 1} {name}")
            for i, (ps, rs) in enumerate(zip(prog["losses"], ref["losses"]))
            for name, p, r in zip("gd", ps, rs)]
    if len(prog["losses"]) != len(ref["losses"]):
        gaps.append((float("inf"), "steps missing"))
    out["loss_gap"] = max(gaps, key=lambda g: float("inf") if g[0] != g[0] else g[0])
    out["loss_gap.step1"] = max(gaps[:2], key=lambda g: float("inf") if g[0] != g[0] else g[0])
    for part in ("g", "d"):
        grads = leaf_gaps(prog["grads"][part], ref["grads"][part])
        change = leaf_gaps(prog["change"][part], ref["change"][part], moved_leaves(ref["grads"][part]))
        named = [("grad_gap", grads), ("change_gap", change)]
        live = live_stats(ref["change"][part])
        if live:
            named.append(("stats_gap", leaf_gaps(prog["change"][part], ref["change"][part], live)))
        for name, g in named:
            out[f"{name}.{part}"] = worst(g)
            out[f"{name}.{part}.median"] = _median(g)
    return out
