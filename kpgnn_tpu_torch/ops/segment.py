"""Segment reductions and the COO k-hop aggregation (counterpart of
kpgnn_tpu/ops/segment.py).

Pooling, per-graph statistics and virtual-node updates reduce node rows
into graph slots by id.  ``khop_aggregate`` is the COO backend's
gather -> mask -> segment reduction (``--backend coo``), on ``index_add_``
and ``scatter_reduce``: plain PyTorch by design, as the JAX COO backend
is plain XLA.  On the card ``index_add_`` sums with atomics, so its
summation order varies from run to run.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def segment_sum(data: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sums of rows by segment id, in data's dtype.  Floats narrower than
    f32 (bf16) accumulate in f32 and are cast back once, as the JAX
    package's one-hot segment sums do."""
    acc = (torch.float32 if data.is_floating_point()
           and data.element_size() < 4 else data.dtype)
    out = torch.zeros((num_segments,) + tuple(data.shape[1:]),
                      dtype=acc, device=data.device)
    return out.index_add_(0, segment_ids.long(), data.to(acc)).to(data.dtype)


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


def multi_hop_degree(edge_attr: torch.Tensor, receivers: torch.Tensor,
                     num_nodes: int, add_self_loop: bool = False
                     ) -> torch.Tensor:
    """(N, K) per-hop in-degree: the edges with a live hop entry per
    receiver; ``add_self_loop`` adds GCN's analytic self-loop."""
    deg = segment_sum((edge_attr > 0).float(), receivers, num_nodes)
    return deg + 1.0 if add_self_loop else deg


def khop_aggregate(x: torch.Tensor,             # (N, K, D)
                   senders: torch.Tensor,       # (E,)
                   receivers: torch.Tensor,     # (E,)
                   edge_emb: torch.Tensor,      # (E, K, D)
                   edge_attr: torch.Tensor,     # (E, K) int, 0 = absent
                   edge_mask: torch.Tensor,     # (E,) real edges
                   *,
                   scale: Optional[torch.Tensor] = None,      # (E, K)
                   aggr: str = "add",
                   num_segments: Optional[int] = None) -> torch.Tensor:
    """out[i, k] = aggr over edges e into i of
    live[e, k] * scale[e, k] * (x[senders[e], k] + edge_emb[e, k]).

    ``mean`` divides by the receiver's union in-degree over real edges
    (``edge_mask``), whatever the hop mask.  ``max`` takes the masked
    messages: a union edge dead at hop k gives a literal 0.0, padded
    edges are left out, and a receiver without a union edge reads 0.
    The sender rows are gathered with ``F.embedding``, not ``x[senders]``:
    a batch's padded edges all start at one node, and the indexing
    gather's backward serialises on a repeated id on the card (545 of
    584 device ms per flagship coo step, PERF.md §5).  The output has
    ``num_segments`` rows (default: x's; a node shard reads senders from
    a halo-extended table longer than its own rows)."""
    n = x.shape[0] if num_segments is None else num_segments
    msg = F.embedding(senders.long(), x.reshape(x.shape[0], -1)).reshape(
        (-1,) + tuple(x.shape[1:])) + edge_emb
    if scale is not None:
        msg = msg * scale[..., None]
    msg = torch.where((edge_attr > 0)[..., None], msg,
                      torch.zeros((), dtype=msg.dtype, device=msg.device))
    if aggr == "add":
        return segment_sum(msg, receivers, n)
    if aggr == "mean":
        cnt = segment_sum(edge_mask.float(), receivers, n)
        total = segment_sum(msg, receivers, n)
        return total / torch.clamp(cnt, min=1.0)[:, None, None]
    if aggr == "max":
        msg = torch.where(edge_mask[:, None, None], msg,
                          torch.full((), -torch.inf, dtype=msg.dtype,
                                     device=msg.device))
        out = segment_max(msg, receivers, n)
        return torch.where(torch.isfinite(out), out,
                           torch.zeros((), dtype=out.dtype, device=out.device))
    raise ValueError(f"unknown aggr {aggr!r}")
