"""K-hop message-passing convolutions (counterpart of
kpgnn_tpu/nn/layers.py).

This slice ports KP-GIN+ (the flagship's layer).  KPGIN, KPGCN,
KPGraphSAGE and GINE are not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.adjacency import khop_aggregate_adj
from .basic import MLP
from .combine import make_combine
from .embed import small_table_lookup, zero_row
from .inits import normal_


class _EdgeTables(nn.Module):
    """Edge/path embedding tables (hop1_edge_emb, hopk_edge_emb,
    hopk_node_path_emb).  Row 0 is the mask value and is zeroed at use."""

    def _make_edge_tables(self, K: int, width: int, num_hop1_edge: int,
                          num_pe: int) -> None:
        self.hop1_edge_emb = nn.Parameter(
            torch.empty(num_hop1_edge + 2, width))
        if K > 1:
            self.hopk_edge_emb = nn.Parameter(torch.empty(num_pe + 2, width))
            self.hopk_node_path_emb = nn.Parameter(
                torch.empty(num_pe, width))
        else:
            self.register_parameter("hopk_edge_emb", None)
            self.register_parameter("hopk_node_path_emb", None)

    def init_params(self, generator: torch.Generator) -> None:
        for p in (self.hop1_edge_emb, self.hopk_edge_emb,
                  self.hopk_node_path_emb):
            if p is not None:
                normal_(p, generator)


def _add_path_encoding_hm(x_hops: torch.Tensor,
                          tpe: Optional[torch.Tensor],
                          pe_attr: Optional[torch.Tensor]) -> torch.Tensor:
    """x_hops (k, N, H): hops 1.. gain the path-encoding embedding of
    their pe_attr column."""
    if tpe is None or pe_attr is None or x_hops.shape[0] == 1:
        return x_hops
    table = zero_row(tpe).to(x_hops.dtype)
    pe = torch.stack([small_table_lookup(table, pe_attr[:, i])
                      for i in range(x_hops.shape[0] - 1)], dim=0)
    return torch.cat([x_hops[:1], x_hops[1:] + pe], dim=0)


class KPGINPlusConv(_EdgeTables):
    """KP-GIN+: full hidden width per hop.  x is the hop-major (k, N, H)
    window of previous layer outputs and peripheral_attr its hop-major
    peripheral embedding; exact GELU after the aggregation, then the
    combine and a shared BN MLP."""

    def __init__(self, hidden_size: int, K: int, num_hop1_edge: int = 1,
                 num_pe: int = 1, combine: str = "geometric"):
        super().__init__()
        self.K = K
        self._make_edge_tables(K, hidden_size, num_hop1_edge, num_pe)
        self.combine = (make_combine(combine, K, hidden_size, hop_major=True)
                        if K > 1 else None)
        self.mlp = MLP(hidden_size, [hidden_size, hidden_size],
                       use_batchnorm=True)

    def forward(self, x, adj, pe_attr=None, peripheral_attr=None,
                node_mask=None, train: bool = False) -> torch.Tensor:
        x = _add_path_encoding_hm(x, self.hopk_node_path_emb, pe_attr)
        x_n = khop_aggregate_adj(adj, x, self.hop1_edge_emb,
                                 self.hopk_edge_emb, hop_major=True)
        x_n = F.gelu(x_n, approximate="none")
        if peripheral_attr is not None:
            x_n = x_n + peripheral_attr
        h = self.combine(x_n) if self.K > 1 else x_n[0]
        return self.mlp(h, mask=node_mask, train=train)


def make_gnn_layer(model_name: str, hidden_size: int, K: int,
                   num_layer: int = 1, num_hop1_edge: int = 1,
                   num_pe: int = 1, combine: str = "geometric",
                   aggr: str = "mean", train_eps: bool = False):
    """Layer factory.  For KPGINPlus returns ``make(l)`` building layer l
    with hop count k_l = min(l + 1, K)."""
    if model_name == "KPGINPlus":
        def make(l):                                    # noqa: E741
            return KPGINPlusConv(hidden_size, min(l + 1, K), num_hop1_edge,
                                 num_pe, combine)
        return make
    if model_name in ("KPGCN", "KPGIN", "KPGINPrime", "KPGraphSAGE"):
        raise NotImplementedError(
            f"{model_name} is not ported yet (ROADMAP.md, Queue 1)")
    raise ValueError("Not supported GNN type")
