"""Learning-rate schedules (counterpart of tgt_tpu/training/schedules.py;
``PlateauController`` comes with ROADMAP.md item 1k).

Each schedule maps the optimizer step (a host int) to the learning rate,
computed in float32 as tgt_tpu computes it:
- ``warmup_cosine``: linear warmup to the peak, then cosine decay over the
  step budget down to a floor (reference training_mixins.py:276-317);
- ``warmup_linear``: warmup only (mixins :259-273);
- ``constant``.
"""
from __future__ import annotations

import math

import numpy as np


def warmup_cosine(max_lr: float, warmup_steps: int, total_steps: int,
                  min_lr: float = 1e-6, halfwave: bool = False):
    """step <= warmup: min + (max-min) * step/warmup; else
    min + (max-min) * (1+cos(pi p))/2 (full wave) or cos(pi p/2) (halfwave),
    p = (step-warmup)/(total-warmup) clipped to [0, 1]."""
    f = np.float32

    def schedule(step: int) -> float:
        s = f(step)
        if s <= warmup_steps:
            return float(f(min_lr) + f(max_lr - min_lr) * s
                         / f(max(warmup_steps, 1)))
        p = np.clip((s - f(warmup_steps)) / f(max(total_steps - warmup_steps,
                                                  1)), f(0), f(1))
        if halfwave:
            return float(f(min_lr) + f(max_lr - min_lr)
                         * np.cos(f(0.5 * math.pi) * p))
        return float(f(min_lr) + f(max_lr - min_lr) * f(0.5)
                     * (f(1) + np.cos(f(math.pi) * p)))

    return schedule


def warmup_linear(peak_lr: float, warmup_steps: int):
    def schedule(step: int) -> float:
        return float(np.float32(peak_lr) * min(
            np.float32(step) / np.float32(max(warmup_steps, 1)),
            np.float32(1)))

    return schedule


def constant(lr: float):
    def schedule(step: int) -> float:
        return float(np.float32(lr))

    return schedule
