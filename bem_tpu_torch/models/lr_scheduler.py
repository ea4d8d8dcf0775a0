"""LR schedules as ``step -> lr`` functions, counterpart of
bem_tpu/models/lr_scheduler.py: the seven schedules of its ``_SCHEDULES``
(lr_scheduler.py:126-149), each composable with :func:`with_warmup`. Step 0
is the first update, as optax counts; the optimizer evaluates the schedule
at the step before it increments it. bem_tpu evaluates them in float32
(jnp), the port in Python floats."""

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


def cosine_annealing_restart_lr(base_lr: float, periods: Sequence[int],
                                restart_weights: Sequence[float] = (1,), eta_min: float = 0.0):
    """The cyclic schedule with one floor for every period (lr_scheduler.py:51)."""
    return cosine_annealing_restart_cyclic_lr(base_lr, periods, restart_weights,
                                              [eta_min] * len(periods))


def multi_step_restart_lr(base_lr: float, milestones: Sequence[int], gamma: float = 0.1,
                          restarts: Sequence[int] = (0,),
                          restart_weights: Sequence[float] = (1,)):
    """Step decay by ``gamma`` at each milestone, restarted at each restart
    with its weight (lr_scheduler.py:62): the decays counted are those
    after the latest restart at or before the step."""
    milestones = sorted(milestones)

    def schedule(step) -> float:
        idx = min(max(sum(step >= r for r in restarts) - 1, 0), len(restart_weights) - 1)
        last = restarts[idx]
        decays = sum(m > last and step >= m for m in milestones)
        return base_lr * restart_weights[idx] * gamma ** decays

    return schedule


def linear_lr(base_lr: float, total_iter: int):
    """base_lr * (1 - step / total_iter) (lr_scheduler.py:87)."""
    return lambda step: base_lr * (1.0 - step / total_iter)


def vibrate_lr(base_lr: float, total_iter: int):
    """A triangle wave of period total_iter // 80 under a falling envelope
    (lr_scheduler.py:94): 1 - 8/3 of the progress until 3/8, then 0.2,
    then 0.1 from 5/8; at least 0.1 in the first half period. total_iter
    must be at least 160 (a half period of one step)."""
    T = total_iter // 80
    Th = T // 2

    def schedule(step) -> float:
        process = step / total_iter
        f = 1.0 - process * 8 / 3 if process < 3 / 8 else (0.2 if process < 5 / 8 else 0.1)
        t = step % T
        f2 = t / Th
        if t >= Th:
            f2 = 2.0 - f2
        w = f * f2
        if step < Th:
            w = max(0.1, w)
        return base_lr * w

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
    "CosineAnnealingRestartLR": lambda lr, opt: cosine_annealing_restart_lr(
        lr, opt["periods"], opt.get("restart_weights", (1,)), opt.get("eta_min", 0.0)),
    "MultiStepLR": lambda lr, opt: multi_step_restart_lr(
        lr, opt["milestones"], opt.get("gamma", 0.1)),
    "MultiStepRestartLR": lambda lr, opt: multi_step_restart_lr(
        lr, opt["milestones"], opt.get("gamma", 0.1), opt.get("restarts", (0,)),
        opt.get("restart_weights", (1,))),
    "LinearLR": lambda lr, opt: linear_lr(lr, opt["total_iter"]),
    "VibrateLR": lambda lr, opt: vibrate_lr(lr, opt["total_iter"]),
    "TrueCosineAnnealingLR": lambda lr, opt: cosine_annealing_restart_lr(
        lr, [opt["T_max"]], (1,), opt.get("eta_min", 0.0)),
}


def build_schedule(base_lr: float, scheduler_opt: dict):
    opt = dict(scheduler_opt)
    stype = opt.pop("type")
    if stype not in _SCHEDULES:
        raise NotImplementedError(f"Scheduler {stype} is not implemented")
    return _SCHEDULES[stype](base_lr, opt)
