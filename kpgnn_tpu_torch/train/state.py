"""Optimizer construction, learning-rate access and the parameter count
(counterpart of kpgnn_tpu/train/state.py).  Adam, or AdamW (decoupled
weight decay) when l2_wd > 0, as the JAX package's optax choice."""
from __future__ import annotations

import torch


def make_optimizer(params, lr: float, l2_wd: float = 0.0
                   ) -> torch.optim.Optimizer:
    if l2_wd > 0:
        return torch.optim.AdamW(params, lr=lr, weight_decay=l2_wd)
    return torch.optim.Adam(params, lr=lr)


def get_lr(opt: torch.optim.Optimizer) -> float:
    return float(opt.param_groups[0]["lr"])


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr



def count_parameters(model: torch.nn.Module) -> int:
    """Elements of the model's parameters (buffers such as running
    statistics are not parameters, as they are not in flax's params)."""
    return sum(p.numel() for p in model.parameters())
