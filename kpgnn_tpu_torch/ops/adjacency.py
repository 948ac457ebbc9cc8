"""Adjacency backends for the k-hop aggregation (counterpart of
kpgnn_tpu/ops/adjacency.py).

Four backends, one logical op:

* ``COOAdj`` (``--backend coo``): the receiver-sorted, padded edge list
  of a collated batch; the aggregation is gather -> mask -> segment
  reduction in plain PyTorch (ops/segment.py), node-major, add, mean or
  max.
* ``KHopPlan`` (``--backend pallas``): the fused-hop CSR plan of the
  hand-written kernel (ops/spmm.py), natively hop-major, add or mean.
* ``DenseAdj`` (``--backend dense``): per-graph (B, K, n, n) hop-attr
  tiles for molecule-sized graphs (n <= ~64).  Neighbour sums are
  batched (n, n) @ (n, D) matmuls on cuBLAS and the edge-embedding sum
  is ``counts @ table`` over per-(node, hop) code histograms; add (both
  layouts), mean, max and the GCN scales (node-major).  As in the JAX
  package it is not hop-major native: only KPGINPlus calls it hop-major.
* ``BandedAdj`` (``--backend banded``, ops/banded.py): tiled halo-window
  masks for large, locally ordered graphs; the in-band sum is one
  batched matmul, the out-of-band edges a COO spill list.  Natively
  hop-major, add or mean, GCN's sender scale folded into the plan.
* ``ShardedCOOAdj`` (``--parallel node``, ops/sharded_adjacency.py): one
  rank's shard of a node-partitioned batch; a halo exchange, then the
  local aggregation on COO, the kernel's rectangular plan or a banded
  plan (hop-major native with either plan).

out[i,k] = aggr_j live * s_i[k] * s_j[k] * (x[j,k] + emb_k(attr)).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..nn.embed import small_table_lookup, zero_row
from .banded import BandedAdj, banded_khop_aggregate
from .segment import khop_aggregate, multi_hop_degree, segment_sum
from .sharded_adjacency import (ShardedCOOAdj, sharded_degree,
                                sharded_khop_aggregate,
                                sharded_union_in_degree)
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


@dataclasses.dataclass
class DenseAdj:
    """hop_attr[b, k, i, j] = attr code of union edge j -> i at hop k (0 =
    absent).  counts1/countsk are per-(node, hop) histograms of the codes
    over j, so the edge-embedding sum is ``counts @ table``."""

    hop_attr: torch.Tensor              # (B, K, n, n) int32
    counts1: torch.Tensor               # (B, n, V1) f32
    countsk: Optional[torch.Tensor]     # (B, n, K-1, Vk) f32 | None if K == 1

    @classmethod
    def from_codes(cls, hop_attr: torch.Tensor, v1: int, vk: int
                   ) -> "DenseAdj":
        """The code histograms of ``hop_attr``, computed on its device.
        Codes are clipped into [0, v - 1] (an out-of-vocabulary code
        counts in the last bin) and bin 0, the mask code, is zeroed."""
        hop = hop_attr.long()

        def hist(codes, v):                 # (..., n_j) -> (..., v)
            out = torch.zeros(codes.shape[:-1] + (v,), device=codes.device)
            out.scatter_add_(-1, codes.clamp(0, v - 1),
                             torch.ones(codes.shape, device=codes.device))
            out[..., 0] = 0.0
            return out
        countsk = (hist(hop[:, 1:], vk).transpose(1, 2).contiguous()
                   if hop.shape[1] > 1 else None)
        return cls(hop_attr=hop_attr.int(), counts1=hist(hop[:, 0], v1),
                   countsk=countsk)

    @property
    def K(self) -> int:
        return self.hop_attr.shape[1]

    @property
    def B(self) -> int:
        return self.hop_attr.shape[0]

    @property
    def n(self) -> int:
        return self.hop_attr.shape[-1]

    def slice_hops(self, k: int) -> "DenseAdj":
        return dataclasses.replace(
            self, hop_attr=self.hop_attr[:, :k],
            countsk=self.countsk[:, :, :k - 1] if k > 1 else None)

    def to(self, device) -> "DenseAdj":
        return dataclasses.replace(
            self, hop_attr=self.hop_attr.to(device),
            counts1=self.counts1.to(device),
            countsk=None if self.countsk is None
            else self.countsk.to(device))


def _unported(adj) -> NotImplementedError:
    return NotImplementedError(
        f"aggregation over {type(adj).__name__} is not ported (ROADMAP.md, "
        "Queue 1): collate in 'coo', 'pallas', 'dense' or 'banded' mode, "
        "or partition the batch (parallel/partition.py)")


def hop_major_native(adj) -> bool:
    """True for backends whose aggregation is natively hop-major
    (K, N, D): the kernel plan, banded, and a node shard carrying
    either."""
    if isinstance(adj, ShardedCOOAdj):
        return adj.plan is not None or adj.banded is not None
    return isinstance(adj, (KHopPlan, BandedAdj))


def degree(adj, add_self_loop: bool = False) -> torch.Tensor:
    """(N, K) per-hop in-degree over live hop entries."""
    if isinstance(adj, ShardedCOOAdj):
        return sharded_degree(adj, add_self_loop)
    if isinstance(adj, COOAdj):
        return multi_hop_degree(adj.edge_attr, adj.receivers, adj.n_nodes,
                                add_self_loop)
    if isinstance(adj, (KHopPlan, BandedAdj)):
        deg = adj.degree()
    elif isinstance(adj, DenseAdj):     # (B, K, n) live counts -> (B, n, K)
        deg = (adj.hop_attr > 0).sum(-1).transpose(1, 2).float()
        deg = deg.reshape(-1, adj.K)
    else:
        raise _unported(adj)
    return deg + 1.0 if add_self_loop else deg


def union_in_degree(adj) -> torch.Tensor:
    """(N,) count of union edges into each node, regardless of hop
    mask."""
    if isinstance(adj, COOAdj):
        return segment_sum(adj.edge_mask.float(), adj.receivers, adj.n_nodes)
    if isinstance(adj, (KHopPlan, BandedAdj)):
        return adj.union_deg
    if isinstance(adj, DenseAdj):
        return (adj.hop_attr > 0).any(1).sum(-1).float().reshape(-1)
    raise _unported(adj)


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
    layout natively, banded hop-major natively (node-major pays one
    transpose each way), dense runs hop-major add natively; otherwise a
    hop-major x is transposed at the boundary.  A node shard exchanges
    its halo and aggregates locally in x's layout."""
    if isinstance(adj, ShardedCOOAdj):
        return sharded_khop_aggregate(adj, x, table1, tablek, scale=scale,
                                      sender_scale=sender_scale, aggr=aggr,
                                      hop_major=hop_major)
    if isinstance(adj, KHopPlan):
        return khop_spmm(x, table1, tablek, adj, scale=scale,
                         sender_scale=sender_scale, aggr=aggr,
                         hop_major=hop_major)
    if isinstance(adj, BandedAdj):
        return banded_khop_aggregate(x, table1, tablek, adj, scale=scale,
                                     sender_scale=sender_scale, aggr=aggr,
                                     hop_major=hop_major)
    if not isinstance(adj, (COOAdj, DenseAdj)):
        raise _unported(adj)
    plain = scale is None and sender_scale is None and aggr == "add"
    if isinstance(adj, DenseAdj) and hop_major and plain:
        return _dense_add_hm(adj, x, zero_row(table1).to(x.dtype),
                             _zero_row_or_none(tablek, x.dtype))
    if hop_major:
        out = khop_aggregate_adj(adj, x.transpose(0, 1), table1, tablek,
                                 scale=scale, sender_scale=sender_scale,
                                 aggr=aggr)
        return out.transpose(0, 1)
    if isinstance(adj, DenseAdj):
        return _dense_aggregate(adj, x, zero_row(table1).to(x.dtype),
                                _zero_row_or_none(tablek, x.dtype),
                                scale, sender_scale, aggr)
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


def _zero_row_or_none(table: Optional[torch.Tensor], dtype):
    return None if table is None else zero_row(table).to(dtype)


def _dense_add_hm(adj: DenseAdj, x, table1, tablek) -> torch.Tensor:
    """Hop-major add (KPGINPlus): x (K, B*n, D) -> (K, B*n, D), one
    batched (n, n) @ (n, D) matmul per (hop, graph) plus counts @ table."""
    K, B, n = adj.K, adj.B, adj.n
    D = x.shape[-1]
    live = (adj.hop_attr > 0).transpose(0, 1).to(x.dtype)   # (K, B, n, n)
    neigh = live @ x.reshape(K, B, n, D)
    emb = adj.counts1.to(x.dtype) @ table1                  # (B, n, D)
    if K > 1:
        embk = adj.countsk.permute(2, 0, 1, 3).to(x.dtype) @ tablek
        emb = torch.cat([emb[None], embk], dim=0)           # (K, B, n, D)
    return (neigh + emb).reshape(K, B * n, D)


def _dense_aggregate(adj: DenseAdj, x, table1, tablek, scale, sender_scale,
                     aggr: str) -> torch.Tensor:
    """Node-major x (B*n, K, D): add or mean with the receiver ``scale``
    and ``sender_scale`` (GCN's factored norm), or max."""
    K, B, n = adj.K, adj.B, adj.n
    D = x.shape[-1]
    if aggr == "max":
        if scale is not None or sender_scale is not None:
            raise ValueError("aggr='max' composes with no edge scales (the "
                             "reference only pairs max with KPGraphSAGE, "
                             "which is unscaled)")
        return _dense_max(adj, x, table1, tablek)
    if aggr not in ("add", "mean"):
        raise ValueError(f"dense adjacency does not support aggr={aggr!r}")
    live = (adj.hop_attr > 0).to(x.dtype)                   # (B, K, n, n)
    if sender_scale is not None:
        sj = sender_scale.reshape(B, n, K).transpose(1, 2)  # (B, K, n)
        live = live * sj[:, :, None, :]
        emb = _dense_weighted_emb(adj, sj, table1, tablek, x.dtype)
    else:
        emb = (adj.counts1.to(x.dtype) @ table1)[:, :, None]  # (B, n, 1, D)
        if K > 1:
            emb = torch.cat([emb, adj.countsk.to(x.dtype) @ tablek], dim=2)
    neigh = (live @ x.reshape(B, n, K, D).transpose(1, 2)).transpose(1, 2)
    out = neigh + emb                                       # (B, n, K, D)
    if scale is not None:
        out = out * scale.reshape(B, n, K)[..., None]
    if aggr == "mean":
        cnt = union_in_degree(adj).reshape(B, n)
        out = out / torch.clamp(cnt, min=1.0)[..., None, None]
    return out.reshape(-1, K, D)


def _dense_max(adj: DenseAdj, x, table1, tablek) -> torch.Tensor:
    """The reference's max on the dense layout: per (receiver i, hop k),
    the max over i's union edges of the masked message.  A live edge
    gives x_j + emb(attr), a union edge dead at hop k gives a literal
    0.0, and a receiver with no union edges reads 0.  Max does not fold
    into counts @ table, so each hop builds its (B, n, n, D) messages."""
    K, B, n = adj.K, adj.B, adj.n
    D = x.shape[-1]
    xb = x.reshape(B, n, K, D)
    union_deg = (adj.hop_attr > 0).any(1).sum(-1)               # (B, n)
    outs = []
    for k in range(K):
        attr = adj.hop_attr[:, k]                               # (B, n, n)
        emb = small_table_lookup(table1 if k == 0 else tablek, attr)
        msg = xb[:, None, :, k, :] + emb                        # [b, i, j, d]
        live = (attr > 0)[..., None]
        live_max = torch.where(live, msg, -torch.inf).amax(dim=2)
        has_dead = (union_deg > (attr > 0).sum(-1))[..., None]
        out = torch.where(has_dead,
                          torch.maximum(live_max, live_max.new_zeros(())),
                          live_max)
        outs.append(torch.where(torch.isneginf(out), 0.0, out))
    return torch.stack(outs, dim=2).reshape(B * n, K, D)


def _dense_weighted_emb(adj: DenseAdj, sj, table1, tablek, dtype
                        ) -> torch.Tensor:
    """(B, n, K, D) sum_j s_j * emb(attr[k, i, j]) for sender scales sj
    (B, K, n), from sender-weighted code histograms."""
    out = []
    for k in range(adj.K):
        table = table1 if k == 0 else tablek
        oh = (adj.hop_attr[:, k, ..., None]
              == torch.arange(table.shape[0], device=table.device)
              ).to(dtype)                                       # (B,n,n,V)
        wc = torch.einsum("bijv,bj->biv", oh, sj[:, k])
        out.append(wc @ table)
    return torch.stack(out, dim=2)
