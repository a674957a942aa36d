"""Learning-rate schedule: cosine annealing with linear warmup and restarts.

Counterpart of the JAX package's ``train/schedule.py`` (reference
scheduler.py, CosineAnnealingWarmupRestarts): lr starts at ``min_lr``,
warms up linearly to ``max_lr`` over ``warmup_steps`` and cosine-decays
back to ``min_lr`` over the rest of the cycle; optional restarts with
period growth ``cycle_mult`` and peak decay ``gamma``.  ``driver.train`` uses
one cycle of ``iter_N + 1`` steps.  Step indexing is 0-based in completed
updates: train iteration ``i`` (1-based) runs with ``schedule(i - 1)``,
which the train step sets on the optimizer before each update.
"""
from __future__ import annotations

import math
from typing import Callable


def cosine_annealing_warmup_restarts(step: int, first_cycle_steps: int,
                                     warmup_steps: int = 0,
                                     max_lr: float = 0.1,
                                     min_lr: float = 0.001,
                                     cycle_mult: float = 1.0,
                                     gamma: float = 1.0) -> float:
    """lr at 0-based ``step``."""
    fcs = float(first_cycle_steps)
    if cycle_mult == 1.0:
        cycle = math.floor(step / fcs)
        sic = step - cycle * fcs
        cycle_len = fcs
    else:
        cycle = math.floor(math.log(step / fcs * (cycle_mult - 1.0) + 1.0)
                           / math.log(cycle_mult))
        sic = step - fcs * (cycle_mult ** cycle - 1.0) / (cycle_mult - 1.0)
        cycle_len = fcs * cycle_mult ** cycle
    peak = max_lr * gamma ** cycle
    if sic < warmup_steps:
        return min_lr + (peak - min_lr) * sic / max(warmup_steps, 1)
    return min_lr + (peak - min_lr) * (1.0 + math.cos(
        math.pi * (sic - warmup_steps) / (cycle_len - warmup_steps))) / 2.0


def ngp_step_decay(step: int, lr: float, start: int, every: int,
                   decay: float) -> float:
    """Instant-NGP's schedule: ``lr``, times ``decay`` at ``start`` and
    every ``every`` steps after it."""
    if step < start:
        return lr
    return lr * decay ** ((step - start) // every + 1)


def schedule_from_cfg(cfg) -> Callable[[int], float]:
    """The reference driver's instance: one cycle of ``iter_N + 1`` steps,
    warmup ``iter_warmup``, peak ``lr``, floor ``lr_min``; for Instant-NGP
    (``arch`` "ngp") ``ngp_step_decay``."""
    if cfg.arch == "ngp":
        from ..models.ngp import LR_DECAY, LR_DECAY_EVERY, LR_DECAY_START

        def ngp_schedule(step: int) -> float:
            return ngp_step_decay(step, cfg.lr, LR_DECAY_START,
                                  LR_DECAY_EVERY, LR_DECAY)
        return ngp_schedule

    def schedule(step: int) -> float:
        return cosine_annealing_warmup_restarts(
            step, cfg.iter_N + 1, cfg.iter_warmup, cfg.lr, cfg.lr_min)
    return schedule
