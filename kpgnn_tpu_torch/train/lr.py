"""Learning-rate control between epochs (counterpart of
kpgnn_tpu/train/lr.py).

ReduceLROnPlateau mirrors torch's semantics used by the reference
(reference: train_ZINC.py:245-252): factor, patience in epochs, floor at
min_lr, in "min" mode (a loss) or "max" mode (an accuracy).  StepDecay is
the TU script's schedule, the LR times ``factor`` every ``every`` epochs
(reference: train_TU.py:119-121).  Both are host-side: the caller writes
the returned lr into the optimizer's param groups between epochs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass
class ReduceLROnPlateau:
    factor: float = 0.5
    patience: int = 10
    min_lr: float = 1e-6
    mode: str = "min"
    threshold: float = 1e-4
    best: Optional[float] = None    # set per mode below
    num_bad: int = 0

    def __post_init__(self):
        if self.mode not in ("min", "max"):
            raise ValueError(f"mode {self.mode!r} is neither 'min' nor 'max'")
        if self.best is None:
            # the first metric always improves on it
            self.best = math.inf if self.mode == "min" else -math.inf

    def step(self, metric: float, lr: float) -> float:
        # torch's rel threshold_mode: best * (1 - thr) for min, best *
        # (1 + thr) for max
        improved = (metric < self.best * (1 - self.threshold)
                    if self.mode == "min"
                    else metric > self.best * (1 + self.threshold))
        if improved:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr


@dataclasses.dataclass
class StepDecay:
    every: int = 50
    factor: float = 0.5

    def lr_at(self, base_lr: float, epoch: int) -> float:
        return base_lr * (self.factor ** (epoch // self.every))
