"""Torch-default initializers drawn from an explicit generator
(counterpart of kpgnn_tpu/nn/inits.py).

Every parameter-owning module of the port defines
``init_params(generator)``; ``init_parameters(model, seed)`` walks the
module tree in registration order and calls each one from one
``torch.Generator`` seeded on the CPU, so the initial weights depend only
on the seed and not on the device the model then moves to.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).uniform_(-bound, bound,
                                               generator=generator))
    return t


def normal_(t: torch.Tensor, generator: torch.Generator,
            stddev: float = 1.0, mean: float = 0.0):
    with torch.no_grad():
        t.copy_(torch.empty(t.shape).normal_(mean, stddev,
                                              generator=generator))
    return t


def fan_in_bound(fan_in: int) -> float:
    """torch's Linear rule: U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """(Re)initialize every parameter of ``model`` from ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    for m in model.modules():
        init = getattr(m, "init_params", None)
        if init is not None:
            init(generator)
    return model
