"""Learning-rate schedules, as ``fdgan_tpu/train/schedule.py``: the
reference's linear decay by init_lr/every per tick, floored at 0."""

from __future__ import annotations

from typing import Callable


def linear_decay_schedule(init_lr: float, every: int, start_step: int = 0) -> Callable[[int], float]:
    """lr(count) = max(init_lr − max(count − start_step, 0)·init_lr/every, 0),
    evaluated at the number of updates made so far, as optax evaluates a
    schedule."""
    lrd = init_lr / every

    def schedule(count: int) -> float:
        return max(init_lr - lrd * max(count - start_step, 0), 0.0)

    return schedule


def adjust_learning_rate(current_lr: float, init_lr: float, every: int) -> float:
    """One decay tick of the reference's ``misc.adjust_learning_rate``."""
    return max(current_lr - init_lr / every, 0.0)
