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


def kaiming_uniform_(t: torch.Tensor, generator: torch.Generator,
                     a: float = 0.0):
    """torch.nn.init.kaiming_uniform_ with torch's fan rule: fan_in =
    shape[1] * prod(shape[2:]), so a (K, d_in, d_out) hop weight has
    fan_in d_in * d_out, as in the JAX package."""
    fan_in = t.shape[1] * math.prod(t.shape[2:])
    bound = math.sqrt(2.0 / (1 + a * a)) * math.sqrt(3.0 / fan_in)
    return uniform_(t, bound, generator)


def init_parameters(model: nn.Module, seed: int) -> nn.Module:
    """(Re)initialize every parameter of ``model`` from ``seed``."""
    generator = torch.Generator().manual_seed(seed)
    for m in model.modules():
        init = getattr(m, "init_params", None)
        if init is not None:
            init(generator)
    return model
