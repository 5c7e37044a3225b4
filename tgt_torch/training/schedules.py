"""Learning-rate schedules and the plateau controller (counterpart of
tgt_tpu/training/schedules.py).

Each schedule maps the optimizer step (a host int) to the learning rate,
computed in float32 as tgt_tpu computes it:
- ``warmup_cosine``: linear warmup to the peak, then cosine decay over the
  step budget down to a floor (reference training_mixins.py:276-317);
- ``warmup_linear``: warmup only (mixins :259-273);
- ``constant``.
``PlateauController`` scales the schedule down when validation stalls.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass
class PlateauController:
    """ReduceLROnPlateau (reference training_mixins.py:170-255): multiply
    the learning rate by ``factor`` after ``patience`` epochs without a
    better val metric; signal a stop once it falls below ``stopping_lr``."""

    factor: float = 0.5
    patience: int = 10
    stopping_lr: float = 0.0
    best: float = float("inf")
    bad_epochs: int = 0
    scale: float = 1.0

    def update(self, val_metric: float, current_lr: float) -> bool:
        """Record an epoch's val metric; True means stop training."""
        if val_metric < self.best:
            self.best = val_metric
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs > self.patience:
                self.scale *= self.factor
                self.bad_epochs = 0
        return current_lr * self.scale < self.stopping_lr

    def state_dict(self):
        return {"best": self.best, "bad_epochs": self.bad_epochs,
                "scale": self.scale}

    def load_state_dict(self, d):
        self.best = d["best"]
        self.bad_epochs = d["bad_epochs"]
        self.scale = d["scale"]
