"""LR schedules as ``step -> lr`` functions, counterpart of
bem_tpu/models/lr_scheduler.py. Step 0 is the first update, as optax
counts; the optimizer evaluates the schedule at the step before it
increments it."""

from __future__ import annotations

import math
from typing import Sequence


def cosine_annealing_restart_cyclic_lr(base_lr: float, periods: Sequence[int],
                                       restart_weights: Sequence[float] = (1,),
                                       eta_mins: Sequence[float] = (0,)):
    """Cosine annealing with restarts and a floor per period
    (lr_scheduler.py:24-50): period i holds steps (cum[i-1], cum[i]]."""
    if not len(periods) == len(restart_weights) == len(eta_mins):
        raise ValueError("periods, restart_weights and eta_mins differ in length")
    cum = [sum(periods[:i + 1]) for i in range(len(periods))]
    starts = [0] + cum[:-1]

    def schedule(step) -> float:
        idx = min(sum(step > c for c in cum), len(periods) - 1)
        eta, w = eta_mins[idx], restart_weights[idx]
        return eta + w * 0.5 * (base_lr - eta) * (
            1.0 + math.cos(math.pi * (step - starts[idx]) / periods[idx]))

    return schedule


def with_warmup(schedule, warmup_iter: int, base_lr: float):
    """Linear warmup for step < warmup_iter (lr_scheduler.py:126-135)."""
    if warmup_iter <= 0:
        return schedule

    def warmed(step) -> float:
        if step < warmup_iter:
            return base_lr * (step + 1.0) / warmup_iter
        return schedule(step)

    return warmed


_SCHEDULES = {
    "CosineAnnealingRestartCyclicLR": lambda lr, opt: cosine_annealing_restart_cyclic_lr(
        lr, opt["periods"], opt.get("restart_weights", (1,)), opt.get("eta_mins", (0,))),
}


def build_schedule(base_lr: float, scheduler_opt: dict):
    opt = dict(scheduler_opt)
    stype = opt.pop("type")
    if stype not in _SCHEDULES:
        raise NotImplementedError(f"scheduler {stype} is not ported")
    return _SCHEDULES[stype](base_lr, opt)
