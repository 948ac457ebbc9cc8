"""Task heads (counterpart of kpgnn_tpu/models/heads.py): the graph
heads pool the nodes under the mask and read out per graph; the node
heads read out every node slot, the loss masks the padding."""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..graph.batch import GraphBatch
from ..nn.basic import TorchLinear
from ..ops.segment import (segment_max, segment_mean, segment_softmax,
                           segment_sum)


def pool_nodes(x: torch.Tensor, batch: GraphBatch, method: str,
               gate: Optional[nn.Module] = None) -> torch.Tensor:
    """Masked per-graph pooling into the (g_pad, ...) graph slots."""
    gid, g = batch.node_graph_ids, batch.g_pad
    m = batch.node_mask.to(x.dtype)[:, None]
    if method == "sum":
        return segment_sum(x * m, gid, g)
    if method == "mean":
        return segment_mean(x, gid, g, weights=batch.node_mask)
    if method == "max":
        xm = torch.where(batch.node_mask[:, None], x, -torch.inf)
        out = segment_max(xm, gid, g)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    if method == "attention":
        scores = gate(x)[:, 0]
        att = segment_softmax(scores, gid, g, mask=batch.node_mask)
        return segment_sum(x * att[:, None] * m, gid, g)
    raise ValueError("The pooling method not implemented")


class _GraphHead(nn.Module):
    readout = "regressor"

    def __init__(self, embedding_model: nn.Module, pooling_method: str,
                 hidden_size: int, output_size: int = 1):
        super().__init__()
        self.embedding_model = embedding_model
        self.pooling_method = pooling_method
        self.output_size = output_size
        if pooling_method == "attention":
            self.pool_gate = TorchLinear(hidden_size, 1)
        self.add_module(self.readout, TorchLinear(hidden_size, output_size))

    def pooled(self, batch, train, generator):
        x = self.embedding_model(batch, train=train, generator=generator)
        return pool_nodes(x, batch, self.pooling_method,
                          getattr(self, "pool_gate", None))


class GraphClassification(_GraphHead):
    readout = "classifier"

    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.classifier(self.pooled(batch, train, generator))


class GraphRegression(_GraphHead):
    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None):
        out = self.regressor(self.pooled(batch, train, generator))
        return out[:, 0] if self.output_size == 1 else out


class _NodeHead(nn.Module):
    readout = "regressor"

    def __init__(self, embedding_model: nn.Module, hidden_size: int,
                 output_size: int = 1):
        super().__init__()
        self.embedding_model = embedding_model
        self.output_size = output_size
        self.add_module(self.readout, TorchLinear(hidden_size, output_size))

    def node_out(self, batch, train, generator):
        x = self.embedding_model(batch, train=train, generator=generator)
        return getattr(self, self.readout)(x)


class NodeClassification(_NodeHead):
    readout = "classifier"

    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None):
        return self.node_out(batch, train, generator)


class NodeRegression(_NodeHead):
    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None):
        out = self.node_out(batch, train, generator)
        return out[:, 0] if self.output_size == 1 else out
