"""Adjacency backends for the k-hop aggregation (counterpart of
kpgnn_tpu/ops/adjacency.py).

Two backends, one logical op:

* ``COOAdj`` (``--backend coo``): the receiver-sorted, padded edge list
  of a collated batch; the aggregation is gather -> mask -> segment
  reduction in plain PyTorch (ops/segment.py), node-major, add, mean or
  max.
* ``KHopPlan`` (``--backend pallas``): the fused-hop CSR plan of the
  hand-written kernel (ops/spmm.py), natively hop-major, add or mean.

The dense backend is not ported yet (ROADMAP.md, Queue 1) and raises.

out[i,k] = aggr_j live * s_i[k] * s_j[k] * (x[j,k] + emb_k(attr)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..nn.embed import small_table_lookup, zero_row
from .segment import khop_aggregate, multi_hop_degree, segment_sum
from .spmm import KHopPlan, khop_spmm


@dataclasses.dataclass
class COOAdj:
    """Receiver-sorted, padded edge list of a collated batch."""

    senders: torch.Tensor       # (E,) int32
    receivers: torch.Tensor     # (E,) int32, sorted ascending
    edge_attr: torch.Tensor     # (E, K) int32, 0 = hop absent
    edge_mask: torch.Tensor     # (E,) bool
    n_nodes: int

    @property
    def K(self) -> int:
        return self.edge_attr.shape[1]

    def slice_hops(self, k: int) -> "COOAdj":
        return dataclasses.replace(self, edge_attr=self.edge_attr[:, :k])

    def to(self, device) -> "COOAdj":
        return dataclasses.replace(
            self, senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            edge_attr=self.edge_attr.to(device),
            edge_mask=self.edge_mask.to(device))


def _unported(adj) -> NotImplementedError:
    return NotImplementedError(
        f"aggregation over {type(adj).__name__} is not ported yet "
        "(ROADMAP.md, Queue 1): collate in 'coo' or 'pallas' mode")


def hop_major_native(adj) -> bool:
    """True for backends whose aggregation is natively hop-major
    (K, N, D)."""
    return isinstance(adj, KHopPlan)


def degree(adj, add_self_loop: bool = False) -> torch.Tensor:
    """(N, K) per-hop in-degree over live hop entries."""
    if isinstance(adj, COOAdj):
        return multi_hop_degree(adj.edge_attr, adj.receivers, adj.n_nodes,
                                add_self_loop)
    if not isinstance(adj, KHopPlan):
        raise _unported(adj)
    deg = adj.degree()
    return deg + 1.0 if add_self_loop else deg


def union_in_degree(adj) -> torch.Tensor:
    """(N,) count of union edges into each node, regardless of hop
    mask."""
    if isinstance(adj, COOAdj):
        return segment_sum(adj.edge_mask.float(), adj.receivers, adj.n_nodes)
    if not isinstance(adj, KHopPlan):
        raise _unported(adj)
    return adj.union_deg


def khop_aggregate_adj(
    adj,
    x: torch.Tensor,                    # (N, K, D) | (K, N, D) hop-major
    table1: torch.Tensor,               # (V1, D) hop-1 edge-emb table
    tablek: Optional[torch.Tensor],     # (Vk, D) hop-k table | None
    *,
    scale: Optional[torch.Tensor] = None,         # (N, K) receiver d_i
    sender_scale: Optional[torch.Tensor] = None,  # (N, K) sender d_j
    aggr: str = "add",
    hop_major: bool = False,
) -> torch.Tensor:
    """The k-hop aggregate in x's layout.  The plan backend runs either
    layout natively; COO transposes a hop-major x at the boundary."""
    if isinstance(adj, KHopPlan):
        return khop_spmm(x, table1, tablek, adj, scale=scale,
                         sender_scale=sender_scale, aggr=aggr,
                         hop_major=hop_major)
    if not isinstance(adj, COOAdj):
        raise _unported(adj)
    if hop_major:
        out = khop_aggregate_adj(adj, x.transpose(0, 1), table1, tablek,
                                 scale=scale, sender_scale=sender_scale,
                                 aggr=aggr)
        return out.transpose(0, 1)
    attr = adj.edge_attr
    e_emb = small_table_lookup(zero_row(table1).to(x.dtype), attr[:, :1])
    if adj.K > 1:
        e_emb = torch.cat([e_emb, small_table_lookup(
            zero_row(tablek).to(x.dtype), attr[:, 1:])], dim=-2)
    edge_scale = None
    if scale is not None or sender_scale is not None:
        edge_scale = 1.0
        if scale is not None:
            edge_scale = scale[adj.receivers.long()]
        if sender_scale is not None:
            edge_scale = edge_scale * sender_scale[adj.senders.long()]
    return khop_aggregate(x, adj.senders, adj.receivers, e_emb, attr,
                          adj.edge_mask, scale=edge_scale, aggr=aggr)
