"""Masked graph normalizations (counterpart of kpgnn_tpu/nn/norms.py).

``nn.BatchNorm1d`` cannot exclude padded rows, so every statistic here is
taken under the node (or graph) mask, per graph through segment sums
where the norm is per graph.  Batch norm: batch mean and biased variance
normalize; the running estimate uses the unbiased variance over the
masked count, momentum 0.1 (torch defaults).  Layer (PyG graph mode),
Instance, GraphSize and Pair follow the JAX package's definitions.

Every norm takes the node ``group``: when the node axis is sharded over
a process group (ops/sharded_adjacency.py), the masked sums and the
per-graph segment sums are local partials, and a differentiable
all-reduce over the group completes them, so the statistics equal the
one-device ones (graph slots are global: per-graph partial tables add).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..ops.segment import segment_sum
from ..ops.sharded_adjacency import preduce


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
                use_running_average: bool = True,
                group=None) -> torch.Tensor:
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
            cnt = torch.clamp(preduce(flat_m.sum(), group), min=1.0)
            mean = preduce((flat_x * flat_m[:, None]).sum(0), group) / cnt
            var = preduce((((flat_x - mean) ** 2) * flat_m[:, None]).sum(0),
                          group) / cnt
            with torch.no_grad():
                unbiased = var * cnt / torch.clamp(cnt - 1.0, min=1.0)
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * unbiased)
        y = (x - mean) * torch.rsqrt(var + self.eps)
        y = y * self.weight + self.bias
        return y.to(in_dtype)


def _node_mask(x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(N, 1) float mask of real rows."""
    if mask is None:
        return torch.ones(x.shape[0], 1, dtype=x.dtype, device=x.device)
    return mask.to(x.dtype)[:, None]


class MaskedGraphLayerNorm(nn.Module):
    """PyG LayerNorm(mode="graph"): per graph, normalize over all of its
    nodes and channels jointly, then an elementwise affine."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()

    def forward(self, x: torch.Tensor, graph_ids: torch.Tensor,
                num_graphs: int, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.float()
        m = _node_mask(x, mask)
        cnt = torch.clamp(preduce(segment_sum(
            m[:, 0] * float(x.shape[-1]), graph_ids, num_graphs), group),
            min=1.0)
        mean = (preduce(segment_sum((x * m).sum(-1), graph_ids, num_graphs),
                        group) / cnt)[graph_ids][:, None]
        xc = (x - mean) * m
        var = (preduce(segment_sum((xc ** 2).sum(-1), graph_ids, num_graphs),
                       group) / cnt)[graph_ids][:, None]
        y = xc * torch.rsqrt(var + self.eps) * self.weight + self.bias
        return y.to(in_dtype)


class MaskedInstanceNorm(nn.Module):
    """PyG InstanceNorm: per graph and channel, without an affine."""

    def __init__(self, eps: float = 1e-5):
        super().__init__()
        self.eps = eps

    def forward(self, x: torch.Tensor, graph_ids: torch.Tensor,
                num_graphs: int, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        in_dtype = x.dtype
        x = x.float()
        m = _node_mask(x, mask)
        cnt = torch.clamp(preduce(segment_sum(m, graph_ids, num_graphs),
                                  group), min=1.0)
        mean = preduce(segment_sum(x * m, graph_ids, num_graphs), group) / cnt
        xc = (x - mean[graph_ids]) * m
        var = preduce(segment_sum(xc ** 2, graph_ids, num_graphs),
                      group) / cnt
        return (xc * torch.rsqrt(var[graph_ids] + self.eps)).to(in_dtype)


class GraphSizeNorm(nn.Module):
    """x_i / sqrt(|G(i)|), |G| counted over real nodes."""

    def forward(self, x: torch.Tensor, graph_ids: torch.Tensor,
                num_graphs: int, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        cnt = preduce(segment_sum(_node_mask(x, mask)[:, 0], graph_ids,
                                  num_graphs), group)
        return x * torch.rsqrt(torch.clamp(cnt, min=1.0))[graph_ids][:, None]


class PairNorm(nn.Module):
    """PairNorm (scale mode PN): center over the batch's real rows, then
    rescale rows to the average row norm."""

    def __init__(self, scale: float = 1.0, eps: float = 1e-5):
        super().__init__()
        self.scale = scale
        self.eps = eps

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                group=None) -> torch.Tensor:
        m = _node_mask(x, mask)
        cnt = torch.clamp(preduce(m.sum(), group), min=1.0)
        xc = (x - preduce((x * m).sum(0), group) / cnt) * m
        return self.scale * xc * torch.rsqrt(preduce((xc ** 2).sum(), group)
                                             / cnt + self.eps)


def make_norm(norm_type: str):
    """The norm class under the reference's keys (reference:
    models/GNNs.py:103-114)."""
    table = {
        "Batch": MaskedBatchNorm,
        "Layer": MaskedGraphLayerNorm,
        "Instance": MaskedInstanceNorm,
        "GraphSize": GraphSizeNorm,
        "Pair": PairNorm,
    }
    if norm_type not in table:
        raise ValueError(f"Not supported norm method {norm_type!r}")
    return table[norm_type]
