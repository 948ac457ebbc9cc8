"""Learning-rate control driven by the epoch's validation loss
(counterpart of kpgnn_tpu/train/lr.py; step decay is not ported yet).

ReduceLROnPlateau mirrors torch's semantics used by the reference
(reference: train_ZINC.py:245-252): factor, patience in epochs, floor at
min_lr, in "min" mode.  It is host-side: the trainer writes the returned
lr into the optimizer's param groups between epochs.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass
class ReduceLROnPlateau:
    factor: float = 0.5
    patience: int = 10
    min_lr: float = 1e-6
    threshold: float = 1e-4
    best: float = math.inf      # the first metric always improves on it
    num_bad: int = 0

    def step(self, metric: float, lr: float) -> float:
        # torch's rel threshold_mode in "min" mode: best * (1 - thr)
        if metric < self.best * (1 - self.threshold):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.num_bad > self.patience:
            self.num_bad = 0
            return max(lr * self.factor, self.min_lr)
        return lr
