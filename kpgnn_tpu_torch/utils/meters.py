"""Running-average meter (counterpart of kpgnn_tpu/utils/meters.py;
reference: train_utils.py:15-41)."""
from __future__ import annotations


class AverageMeter:
    def __init__(self):
        self.reset()

    def reset(self):
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0.0

    def update(self, val: float, n: int = 1):
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1.0)
