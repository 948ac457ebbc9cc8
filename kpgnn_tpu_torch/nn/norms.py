"""Masked batch normalization (counterpart of kpgnn_tpu/nn/norms.py).

``nn.BatchNorm1d`` cannot exclude padded rows, so statistics here are
taken under the node (or graph) mask.  Batch mean and biased variance
normalize; the running estimate uses the unbiased variance over the
masked count, momentum 0.1 (torch defaults).  The other norms of the JAX
package (Layer, Instance, GraphSize, Pair) are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class MaskedBatchNorm(nn.Module):
    def __init__(self, features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                use_running_average: bool = True) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.float()
        features = x.shape[-1]
        if use_running_average:
            mean, var = self.running_mean, self.running_var
        else:
            flat_x = x.reshape(-1, features)
            if mask is None:
                flat_m = torch.ones(flat_x.shape[0], dtype=x.dtype,
                                    device=x.device)
            else:
                flat_m = mask.to(x.dtype).reshape(-1)
            cnt = torch.clamp(flat_m.sum(), min=1.0)
            mean = (flat_x * flat_m[:, None]).sum(0) / cnt
            var = (((flat_x - mean) ** 2) * flat_m[:, None]).sum(0) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(in_dtype)
