"""Learning-rate schedules as plain functions of the step.

pcf_tpu/train/lr.py's families (the reference's util/lr.py schedulers):
MultiStepWithWarmup, CosineAnnealingWarmupRestarts, PolyLR /
PolyLRwithWarmup, SquaredLR, ExpLR, StepLR and OneCycle. Each returns
f(step) -> lr as a Python float; step 0 is the first update.
"""

from __future__ import annotations

import bisect
import math


def _warmup_coeff(step, warmup_iters: int, warmup_ratio: float) -> float:
    """Linear warmup factor (reference: util/lr.py:59-62):
    1 - (1 - s/warmup_iters) * (1 - warmup_ratio) for s <= warmup_iters."""
    if step > warmup_iters:
        return 1.0
    return 1.0 - (1.0 - step / max(warmup_iters, 1)) * (1.0 - warmup_ratio)


def multistep_with_warmup(base_lr: float, milestones, gamma: float = 0.1,
                          warmup_iters: int = 10, warmup_ratio: float = 1e-6):
    """MultiStepWithWarmup (util/lr.py:48-65). Milestones in steps."""
    ms = sorted(milestones or [])

    def schedule(step):
        factor = gamma ** bisect.bisect_right(ms, step)
        return base_lr * factor * _warmup_coeff(step, warmup_iters, warmup_ratio)

    return schedule


def cosine_annealing_warmup_restarts(first_cycle_steps: int, max_lr: float,
                                     min_lr: float = 1e-8, warmup_steps: int = 0,
                                     gamma: float = 1.0, cycle_mult: float = 1.0,
                                     max_cycles: int = 128):
    """CosineAnnealingWarmupRestarts (util/lr.py:121-207): cycle n has length
    c_n, with c_{n+1} = int((c_n - warmup) * cycle_mult) + warmup, and peak
    max_lr * gamma^n; the first `max_cycles` cycles are tabulated."""
    lengths = []
    cur = int(first_cycle_steps)
    for _ in range(max_cycles):
        lengths.append(cur)
        cur = int((cur - warmup_steps) * cycle_mult) + warmup_steps
    ends = []
    for n in lengths:
        ends.append((ends[-1] if ends else 0) + n)

    def schedule(step):
        cycle = min(bisect.bisect_right(ends, step), max_cycles - 1)
        s = step - (ends[cycle - 1] if cycle else 0)
        length = lengths[cycle]
        cycle_max = max_lr * gamma ** cycle
        if s < warmup_steps:
            return min_lr + (cycle_max - min_lr) * s / max(warmup_steps, 1)
        return min_lr + (cycle_max - min_lr) * 0.5 * (
            1.0 + math.cos(math.pi * (s - warmup_steps) / max(length - warmup_steps, 1)))

    return schedule


def poly_with_warmup(base_lr, max_iter, warmup_iters=1500, warmup_ratio=1e-6, power=1.0):
    """PolyLRwithWarmup (util/lr.py:29-46)."""

    def schedule(step):
        coeff = (1.0 - step / (max_iter + 1)) ** power
        return base_lr * coeff * _warmup_coeff(step, warmup_iters, warmup_ratio)

    return schedule


def poly(base_lr, max_iter, power=0.9):
    """PolyLR (util/lr.py:68-74)."""
    return lambda step: base_lr * (1.0 - step / (max_iter + 1)) ** power


def squared(base_lr, max_iter):
    """SquaredLR (util/lr.py:77-81)."""
    return poly(base_lr, max_iter, power=2.0)


def exp(base_lr, step_size, gamma=0.9):
    """ExpLR (util/lr.py:84-90)."""
    return lambda step: base_lr * gamma ** (step / step_size)


def step_lr(base_lr, step_size, gamma=0.1):
    """torch StepLR."""
    return lambda step: base_lr * gamma ** math.floor(step / step_size)


def onecycle(max_lr, total_steps, pct_start=0.3, div_factor=25.0, final_div_factor=1e4):
    """OneCycleLR (util/lr.py:110-113), as optax.cosine_onecycle_schedule:
    cosine from max_lr / div_factor up to max_lr over the first pct_start
    of the steps, then down to max_lr / (div_factor * final_div_factor)."""
    if total_steps <= 0:
        raise ValueError("onecycle needs a positive total_steps")
    bounds = [0, int(pct_start * total_steps), int(total_steps)]
    init = max_lr / div_factor
    values = [init, init * div_factor, init * div_factor / (div_factor * final_div_factor)]

    def schedule(step):
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                return values[i + 1] + (values[i] - values[i + 1]) / 2.0 * (
                    math.cos(math.pi * pct) + 1)
        return values[2] if step >= bounds[2] else 0.0

    return schedule


def from_config(cfg, iter_per_epoch: int):
    """The trainer's schedule from a config (reference wiring:
    train_ScanNet_DDP_WarmUP.py:250-282)."""
    if cfg.scheduler == "MultiStepWithWarmup":
        if cfg.get("milestones"):
            milestones = [int(v * iter_per_epoch) for v in cfg.milestones]
        else:
            milestones = [int(cfg.total_epoches * f) * iter_per_epoch
                          for f in (0.4, 0.6, 0.8)]
        return multistep_with_warmup(
            cfg.learning_rate, milestones, gamma=cfg.gamma,
            warmup_iters=cfg.warmup_epochs * iter_per_epoch,
            warmup_ratio=cfg.warmup_ratio)
    if cfg.scheduler == "CosineAnnealingWarmupRestarts":
        return cosine_annealing_warmup_restarts(
            first_cycle_steps=cfg.total_epoches * iter_per_epoch,
            max_lr=cfg.learning_rate, min_lr=1e-8,
            warmup_steps=cfg.warmup_epochs * iter_per_epoch, gamma=1.0)
    if cfg.scheduler == "Constant":
        return lambda step: cfg.learning_rate
    raise ValueError(f"No such scheduler {cfg.scheduler}")
