"""Adjacency backends for the k-hop aggregation (counterpart of
kpgnn_tpu/ops/adjacency.py).

This slice ports the kernel-plan backend only (``KHopPlan``, the
``--backend pallas`` path).  ``COOAdj`` is the collate output the plan is
built from; aggregating over it directly, and the dense backend, are
not ported yet (ROADMAP.md, Queue 1) and raise.

out[i,k] = aggr_j live * s_i[k] * s_j[k] * (x[j,k] + emb_k(attr)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

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

    def to(self, device) -> "COOAdj":
        return dataclasses.replace(
            self, senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            edge_attr=self.edge_attr.to(device),
            edge_mask=self.edge_mask.to(device))


def _unported(adj) -> NotImplementedError:
    return NotImplementedError(
        f"aggregation over {type(adj).__name__} is not ported yet "
        "(ROADMAP.md, Queue 1): collate in 'pallas' mode for the kernel "
        "plan backend")


def hop_major_native(adj) -> bool:
    """True for backends whose aggregation is natively hop-major
    (K, N, D)."""
    return isinstance(adj, KHopPlan)


def degree(adj, add_self_loop: bool = False) -> torch.Tensor:
    """(N, K) per-hop in-degree over live hop entries."""
    if not isinstance(adj, KHopPlan):
        raise _unported(adj)
    deg = adj.degree()
    return deg + 1.0 if add_self_loop else deg


def union_in_degree(adj) -> torch.Tensor:
    """(N,) count of union edges into each node, regardless of hop
    mask."""
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
    if not isinstance(adj, KHopPlan):
        raise _unported(adj)
    return khop_spmm(x, table1, tablek, adj, scale=scale,
                     sender_scale=sender_scale, aggr=aggr,
                     hop_major=hop_major)
