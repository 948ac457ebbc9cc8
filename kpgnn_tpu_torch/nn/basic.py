"""Small building blocks: torch-initialized Linear and MLP stacks
(counterpart of kpgnn_tpu/nn/basic.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .inits import fan_in_bound, uniform_


class TorchLinear(nn.Module):
    """Linear layer with nn.Linear's default init from a generator."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))

    def init_params(self, generator: torch.Generator) -> None:
        bound = fan_in_bound(self.weight.shape[1])
        uniform_(self.weight, bound, generator)
        uniform_(self.bias, bound, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, self.weight, self.bias)


class MLP(nn.Module):
    """Linear(+masked BN)+ReLU stack (lin0, bn0, lin1, bn1, ...); padded
    rows never enter the BN statistics."""

    def __init__(self, in_features: int, features: Sequence[int],
                 use_batchnorm: bool = False):
        super().__init__()
        from .norms import MaskedBatchNorm

        self.n = len(features)
        self.use_batchnorm = use_batchnorm
        d = in_features
        for i, f in enumerate(features):
            self.add_module(f"lin{i}", TorchLinear(d, f))
            if use_batchnorm:
                self.add_module(f"bn{i}", MaskedBatchNorm(f))
            d = f

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                train: bool = False) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"lin{i}")(x)
            if self.use_batchnorm:
                x = getattr(self, f"bn{i}")(x, mask=mask,
                                            use_running_average=not train)
            x = F.relu(x)
        return x
