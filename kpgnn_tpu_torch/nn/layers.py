"""K-hop message-passing convolutions (counterpart of
kpgnn_tpu/nn/layers.py).

The four KP layers share one skeleton: split node state into K hops of
width d_k, add the hop-k path encoding, run one k-hop aggregation over
the batch's adjacency (``ops.adjacency.khop_aggregate_adj``), add the
peripheral embedding, apply the per-hop transform and combine the hops.
On a hop-major backend (the kernel plan) a layer runs its whole body in
the (K, N, d_k) layout; on COO it runs node-major (N, K, d_k), as the
JAX layers do.  Per-hop weights are (K, d_in, d_out) tensors under the
flax names (``hop_proj1``, ``hop_bias1``, ...), applied as one batched
matmul.  GCN's self-loop enters analytically as deg^-1 * (x + emb(1)),
and its symmetric norm stays factored as receiver and sender scales.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.adjacency import degree, hop_major_native, khop_aggregate_adj
from .basic import MLP, TorchLinear
from .combine import make_combine
from .embed import small_table_lookup, zero_row
from .inits import fan_in_bound, kaiming_uniform_, normal_, uniform_


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


def _l2_normalize(x: torch.Tensor, dim: int = -1,
                  eps: float = 1e-12) -> torch.Tensor:
    norm = torch.sqrt(torch.sum(x * x, dim=dim, keepdim=True))
    return x / torch.clamp(norm, min=eps)


def _add_path_encoding(x_hops: torch.Tensor, tpe: Optional[torch.Tensor],
                       pe_attr: Optional[torch.Tensor]) -> torch.Tensor:
    """x_hops (N, K, H): hops 1.. gain the path-encoding embedding of
    their pe_attr column."""
    if tpe is None or pe_attr is None:
        return x_hops
    pe = small_table_lookup(zero_row(tpe).to(x_hops.dtype), pe_attr)
    return torch.cat([x_hops[:, :1], x_hops[:, 1:] + pe], dim=1)


def _add_path_encoding_hm(x_hops: torch.Tensor,
                          tpe: Optional[torch.Tensor],
                          pe_attr: Optional[torch.Tensor]) -> torch.Tensor:
    """x_hops (k, N, H): hops 1.. gain the path-encoding embedding of
    their pe_attr column."""
    if tpe is None or pe_attr is None or x_hops.shape[0] == 1:
        return x_hops
    pe = small_table_lookup(zero_row(tpe).to(x_hops.dtype),
                            pe_attr[:, :x_hops.shape[0] - 1].t())
    return torch.cat([x_hops[:1], x_hops[1:] + pe], dim=0)


def _self_loop_row(t1: torch.Tensor, tk: Optional[torch.Tensor],
                   K: int) -> torch.Tensor:
    """(K, width) embedding of attr value 1 on every hop column."""
    if K > 1:
        return torch.cat([t1[1:2], tk[1:2].expand(K - 1, -1)], dim=0)
    return t1[1:2]


class _HopLayer(_EdgeTables):
    """Shared parts of the split-width layers (KPGIN, KPGCN,
    KPGraphSAGE): the edge tables at d_k = H / K and, for K > 1, the
    combine and its ``combine_proj``."""

    def __init__(self, hidden_size: int, K: int, num_hop1_edge: int,
                 num_pe: int, combine: str):
        super().__init__()
        if hidden_size % K:
            raise ValueError(f"hidden_size {hidden_size} must divide by "
                             f"K={K}")
        self.K, self.H, self.dk = K, hidden_size, hidden_size // K
        self._make_edge_tables(K, self.dk, num_hop1_edge, num_pe)
        if K > 1:
            self.combine = make_combine(combine, K, self.dk)
            self.combine_proj = TorchLinear(self.dk, hidden_size)

    def _split(self, x: torch.Tensor, hm: bool) -> torch.Tensor:
        x = x.reshape(-1, self.K, self.dk)
        return x.transpose(0, 1) if hm else x

    def _path_encoding(self, x, pe_attr, hm: bool) -> torch.Tensor:
        return (_add_path_encoding_hm if hm else _add_path_encoding)(
            x, self.hopk_node_path_emb, pe_attr)

    def _combine(self, h: torch.Tensor, hm: bool) -> torch.Tensor:
        if self.K == 1:
            return h[0] if hm else h[:, 0]
        return self.combine_proj(self.combine(h, hop_major=hm))


def _hop_matmul(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                hm: bool) -> torch.Tensor:
    """Per-hop h @ w[k] + b[k] as one batched matmul, in h's layout."""
    if hm:
        return torch.baddbmm(b[:, None].to(h.dtype), h, w.to(h.dtype))
    return torch.einsum("nki,kio->nko", h, w.to(h.dtype)) \
        + b[None].to(h.dtype)


class KPGINConv(_HopLayer):
    """KP-GNN with the GIN kernel: per-hop 2-layer MLP after the update
    x_n + (1 + eps) * x; eps is a parameter only with ``train_eps``."""

    def __init__(self, hidden_size: int, K: int, num_hop1_edge: int = 1,
                 num_pe: int = 1, combine: str = "geometric",
                 train_eps: bool = False):
        super().__init__(hidden_size, K, num_hop1_edge, num_pe, combine)
        dk = self.dk
        self.hop_proj1 = nn.Parameter(torch.empty(K, dk, dk))
        self.hop_bias1 = nn.Parameter(torch.empty(K, dk))
        self.hop_proj2 = nn.Parameter(torch.empty(K, dk, dk))
        self.hop_bias2 = nn.Parameter(torch.empty(K, dk))
        self.eps = nn.Parameter(torch.zeros(())) if train_eps else None

    def init_params(self, generator: torch.Generator) -> None:
        super().init_params(generator)
        bound = fan_in_bound(self.dk * self.dk)
        for w, b in ((self.hop_proj1, self.hop_bias1),
                     (self.hop_proj2, self.hop_bias2)):
            kaiming_uniform_(w, generator)
            uniform_(b, bound, generator)
        if self.eps is not None:
            with torch.no_grad():
                self.eps.zero_()

    def forward(self, x, adj, pe_attr=None, peripheral_attr=None,
                node_mask=None, train: bool = False) -> torch.Tensor:
        hm = hop_major_native(adj)
        x = self._path_encoding(self._split(x, hm), pe_attr, hm)
        x_n = khop_aggregate_adj(adj, x, self.hop1_edge_emb,
                                 self.hopk_edge_emb, hop_major=hm)
        if peripheral_attr is not None:
            x_n = x_n + peripheral_attr
        h = x_n + (1.0 + (self.eps if self.eps is not None else 0.0)) * x
        h = F.relu(_hop_matmul(h, self.hop_proj1, self.hop_bias1, hm))
        h = F.relu(_hop_matmul(h, self.hop_proj2, self.hop_bias2, hm))
        return self._combine(h, hm)


class KPGCNConv(_HopLayer):
    """KP-GNN with the GCN kernel: a linear map, then the multi-hop
    symmetric degree norm, receiver and sender scales deg^-1/2 (the
    plan backend pre-scales the gathered rows and rebuilds the
    edge-embedding term from sender-weighted histograms), with the
    self-loop (attr 1 on every hop) added as deg^-1 * (x + emb(1))."""

    def __init__(self, hidden_size: int, K: int, num_hop1_edge: int = 1,
                 num_pe: int = 1, combine: str = "geometric"):
        super().__init__(hidden_size, K, num_hop1_edge, num_pe, combine)
        self.hop_proj = TorchLinear(hidden_size, hidden_size)

    def forward(self, x, adj, pe_attr=None, peripheral_attr=None,
                node_mask=None, train: bool = False) -> torch.Tensor:
        hm = hop_major_native(adj)
        x = self._path_encoding(self._split(self.hop_proj(x), hm), pe_attr,
                                hm)
        deg = degree(adj, add_self_loop=True)               # (N, K)
        dis = torch.rsqrt(deg)
        agg = khop_aggregate_adj(adj, x, self.hop1_edge_emb,
                                 self.hopk_edge_emb, scale=dis,
                                 sender_scale=dis, hop_major=hm)
        tk = self.hopk_edge_emb
        self_emb = _self_loop_row(zero_row(self.hop1_edge_emb),
                                  zero_row(tk) if tk is not None else None,
                                  self.K).to(x.dtype)
        inv = (1.0 / deg).to(x.dtype)
        if hm:
            agg = agg + inv.t()[..., None] * (x + self_emb[:, None])
        else:
            agg = agg + inv[..., None] * (x + self_emb[None])
        h = F.relu(agg)
        if peripheral_attr is not None:
            h = h + peripheral_attr
        return self._combine(h, hm)


class KPGraphSAGEConv(_HopLayer):
    """KP-GNN with the GraphSAGE kernel: the union-degree mean (or max,
    COO only), concat [x, x_n] -> per-hop linear -> ReLU -> L2
    normalize."""

    def __init__(self, hidden_size: int, K: int, aggr: str = "mean",
                 num_hop1_edge: int = 1, num_pe: int = 1,
                 combine: str = "geometric"):
        super().__init__(hidden_size, K, num_hop1_edge, num_pe, combine)
        self.aggr = aggr
        self.hop_proj = nn.Parameter(torch.empty(K, 2 * self.dk, self.dk))
        self.hop_bias = nn.Parameter(torch.empty(K, self.dk))

    def init_params(self, generator: torch.Generator) -> None:
        super().init_params(generator)
        kaiming_uniform_(self.hop_proj, generator)
        uniform_(self.hop_bias, fan_in_bound(2 * self.dk * self.dk),
                 generator)

    def forward(self, x, adj, pe_attr=None, peripheral_attr=None,
                node_mask=None, train: bool = False) -> torch.Tensor:
        hm = hop_major_native(adj)
        x = self._path_encoding(self._split(x, hm), pe_attr, hm)
        x_n = khop_aggregate_adj(adj, x, self.hop1_edge_emb,
                                 self.hopk_edge_emb, aggr=self.aggr,
                                 hop_major=hm)
        if peripheral_attr is not None:
            x_n = x_n + peripheral_attr
        h = _hop_matmul(torch.cat([x, x_n], dim=-1), self.hop_proj,
                        self.hop_bias, hm)
        return self._combine(_l2_normalize(F.relu(h)), hm)


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
        self.combine = (make_combine(combine, K, hidden_size)
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
        h = self.combine(x_n, hop_major=True) if self.K > 1 else x_n[0]
        return self.mlp(h, mask=node_mask, train=train)


class GINEConv(nn.Module):
    """Plain 1-hop GINE for GNNPrime's upper layers: the hop-1 aggregate
    plus (1 + eps) * x, then a BN MLP; eps is a parameter only with
    ``train_eps``."""

    def __init__(self, hidden_size: int, num_hop1_edge: int = 1,
                 eps_init: float = 0.0, train_eps: bool = False):
        super().__init__()
        self.H = hidden_size
        self.eps_init = eps_init
        self.hop1_edge_emb = nn.Parameter(
            torch.empty(num_hop1_edge + 2, hidden_size))
        self.eps = (nn.Parameter(torch.full((), float(eps_init)))
                    if train_eps else None)
        self.mlp = MLP(hidden_size, [hidden_size, hidden_size],
                       use_batchnorm=True)

    def init_params(self, generator: torch.Generator) -> None:
        normal_(self.hop1_edge_emb, generator)
        if self.eps is not None:
            with torch.no_grad():
                self.eps.fill_(self.eps_init)

    def forward(self, x, adj, node_mask=None,
                train: bool = False) -> torch.Tensor:
        x = x.reshape(-1, 1, self.H)
        out = khop_aggregate_adj(adj.slice_hops(1), x, self.hop1_edge_emb,
                                 None)
        eps = self.eps if self.eps is not None else self.eps_init
        out = out + (1.0 + eps) * x
        return self.mlp(out[:, 0], mask=node_mask, train=train)


def make_gnn_layer(model_name: str, hidden_size: int, K: int,
                   num_layer: int = 1, num_hop1_edge: int = 1,
                   num_pe: int = 1, combine: str = "geometric",
                   aggr: str = "mean", train_eps: bool = False):
    """Layer factory: returns ``make(l)`` building layer l.  KPGINPlus's
    layer l has k_l = min(l + 1, K) hops; the other families build the
    same K-hop layer at every l (KPGINPrime's K-hop layers are KPGIN)."""
    if model_name == "KPGINPlus":
        def make(l):                                    # noqa: E741
            return KPGINPlusConv(hidden_size, min(l + 1, K), num_hop1_edge,
                                 num_pe, combine)
        return make
    if model_name == "KPGCN":
        return lambda l: KPGCNConv(hidden_size, K, num_hop1_edge, num_pe,
                                   combine)
    if model_name in ("KPGIN", "KPGINPrime"):
        return lambda l: KPGINConv(hidden_size, K, num_hop1_edge, num_pe,
                                   combine, train_eps)
    if model_name == "KPGraphSAGE":
        return lambda l: KPGraphSAGEConv(hidden_size, K, aggr, num_hop1_edge,
                                         num_pe, combine)
    raise ValueError("Not supported GNN type")
