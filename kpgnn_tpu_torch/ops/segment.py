"""Segment reductions (counterpart of kpgnn_tpu/ops/segment.py).

Pooling, per-graph statistics and virtual-node updates reduce node rows
into graph slots by id.  The COO ``khop_aggregate`` is not ported yet
(ROADMAP.md, Queue 1): the port's aggregation runs on the kernel plan
(ops/spmm.py).
"""
from __future__ import annotations

from typing import Optional

import torch


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    return out.index_add_(0, segment_ids.long(), data)


def segment_mean(data: torch.Tensor, segment_ids: torch.Tensor,
                 num_segments: int,
                 weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean over segments; ``weights`` masks entries out of both the
    numerator and the denominator."""
    if weights is not None:
        w = weights.to(data.dtype)
        while w.dim() < data.dim():
            w = w[..., None]
        data = data * w
        counts = segment_sum(torch.broadcast_to(w, data.shape).contiguous(),
                             segment_ids, num_segments)
    else:
        counts = segment_sum(torch.ones_like(data), segment_ids,
                             num_segments)
    total = segment_sum(data, segment_ids, num_segments)
    return total / torch.clamp(counts, min=1.0)


def segment_max(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Max over segments; an empty segment reads -inf."""
    out = torch.full((num_segments,) + tuple(data.shape[1:]), -torch.inf,
                     dtype=data.dtype, device=data.device)
    idx = segment_ids.long().reshape((-1,) + (1,) * (data.dim() - 1))
    return out.scatter_reduce(0, idx.expand_as(data), data, reduce="amax",
                              include_self=False)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Numerically stable softmax within segments; ``mask`` excludes
    padded entries."""
    if mask is not None:
        logits = torch.where(mask, logits, -torch.inf)
    seg_max = segment_max(logits.detach(), segment_ids, num_segments)
    seg_max = torch.where(torch.isfinite(seg_max), seg_max, 0.0)
    ex = torch.exp(logits - seg_max[segment_ids.long()])
    if mask is not None:
        ex = torch.where(mask, ex, 0.0)
    denom = segment_sum(ex, segment_ids, num_segments)
    return ex / torch.clamp(denom[segment_ids.long()], min=1e-16)
