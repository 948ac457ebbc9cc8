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
from ..ops.sharded_adjacency import all_reduce_max, all_reduce_sum, node_axis
from ..utils.profiling import span


def pool_nodes(x: torch.Tensor, batch: GraphBatch, method: str,
               gate: Optional[nn.Module] = None) -> torch.Tensor:
    """Masked per-graph pooling into the (g_pad, ...) graph slots.  Graph
    slots are global: on a node shard each rank pools its own nodes into
    the full table and one all-reduce over the node group completes it,
    so the pooled output (and the head and loss after it) is
    replicated.  The sums read the batch's ``graph_indptr`` where it has
    one, so the padded nodes past its end are never added."""
    gid, g, ip = batch.node_graph_ids, batch.g_pad, batch.graph_indptr
    grp = node_axis(batch)
    m = batch.node_mask.to(x.dtype)[:, None]
    if method == "sum":
        out = segment_sum(x * m, gid, g, indptr=ip)
        return out if grp is None else all_reduce_sum(out, grp)
    if method == "mean":
        if grp is None:
            return segment_mean(x, gid, g, weights=batch.node_mask,
                                indptr=ip)
        tot = all_reduce_sum(segment_sum(x * m, gid, g, indptr=ip), grp)
        cnt = all_reduce_sum(segment_sum(m, gid, g, indptr=ip), grp)
        return tot / torch.clamp(cnt, min=1.0)
    if method == "max":
        xm = torch.where(batch.node_mask[:, None], x, -torch.inf)
        out = segment_max(xm, gid, g)
        if grp is not None:
            # the max has no gradient of its own: the global max (no grad)
            # plus the summed residual out - out.detach(), zero in value,
            # which carries the gradient from the rank(s) holding the max
            gmax = all_reduce_max(out, grp)
            res = torch.where(out == gmax, out - out.detach(),
                              torch.zeros_like(out))
            out = gmax + all_reduce_sum(res, grp)
        return torch.where(torch.isfinite(out), out, torch.zeros_like(out))
    if method == "attention":
        scores = gate(x)[:, 0]
        if grp is None:
            att = segment_softmax(scores, gid, g, mask=batch.node_mask,
                                  indptr=ip)
            return segment_sum(x * att[:, None] * m, gid, g, indptr=ip)
        s = torch.where(batch.node_mask, scores, -torch.inf)
        # a stabiliser only: the softmax is shift-invariant
        smax = all_reduce_max(segment_max(s.detach(), gid, g), grp)
        smax = torch.where(torch.isfinite(smax), smax, 0.0)
        ex = torch.where(batch.node_mask, torch.exp(s - smax[gid.long()]),
                         0.0)
        denom = all_reduce_sum(segment_sum(ex, gid, g, indptr=ip), grp)
        num = all_reduce_sum(segment_sum(x * ex[:, None] * m, gid, g,
                                         indptr=ip), grp)
        return num / torch.clamp(denom, min=1e-16)[:, None]
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
        with span("model.pool"):
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
