"""Typed training configuration (counterpart of
kpgnn_tpu/train/config.py)."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-3
    min_lr: float = 1e-6
    l2_wd: float = 0.0
    num_epochs: int = 100
    batch_size: int = 64
    seed: int = 234
    runs: int = 1
    # plateau scheduler (reference: train_ZINC.py:245-252)
    factor: float = 0.5
    patience: int = 10
    # loss: "l1" | "mse" | "cross_entropy"
    loss: str = "l1"
    # stop when the plateau scheduler bottoms out (reference ZINC behavior)
    stop_at_min_lr: bool = False
    save_dir: Optional[str] = None
    # warm start from a checkpoint; best-val checkpoints under
    # save_dir/checkpoints (train/checkpoint.py)
    load_path: Optional[str] = None
    save_checkpoints: bool = False
    # torch.profiler chrome trace of epoch 1 (utils/profiling.py)
    profile_dir: Optional[str] = None
