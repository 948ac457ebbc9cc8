"""Node-sharded adjacency with a halo exchange (counterpart of
kpgnn_tpu/ops/sharded_adjacency.py): the graph-parallel backend.

The node axis of a collated batch is split into ``n_shards`` contiguous
ranges, one per rank of a process group.  A rank owns the output rows
of its range and the contiguous span of receiver-sorted edges pointing
into it.  The only cross-rank traffic of a layer is the *boundary*:
node rows its edges read from other ranks' ranges.  They arrive through
one ``all_to_all_single`` of a fixed (n_shards, halo) send plan built on
the host (parallel/partition.py); aggregation is then the ordinary local
one over the halo-extended sender table, on COO, the kernel's
rectangular plan or a banded plan.  Communication per layer is
O(boundary · K · D), never O(N · K · D).

Where the JAX package runs the model inside ``shard_map`` and gets the
gradients from the collectives' transposes, here each collective on the
forward is an ``autograd.Function``: ``all_reduce_sum``'s backward
all-reduces the cotangent by SUM, and ``halo_exchange``'s backward sends
the halo rows' cotangents back with the reverse all_to_all and adds them
into the owned rows they came from (a row sent to several shards gets
several adds, through ``segment.sorted_segment_sum`` over the send plan
sorted once at partition time, so in one order).  With each
rank backpropagating loss / P and the parameter gradients then summed
over the group (parallel/partition.py), every parameter gets exactly
the one-device gradient.

A ``ShardedCOOAdj`` holds ONE rank's shard.  The JAX stacked layout,
``local()`` and the stacked, common-shape plans exist for ``shard_map``
and have no counterpart.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .banded import BandedAdj, banded_khop_aggregate
from .segment import (khop_aggregate, segment_indptr, segment_sum,
                      sorted_segment_sum)
from .spmm import KHopPlan, khop_spmm


class _AllReduceSum(torch.autograd.Function):
    """SUM over the group forward; the cotangent summed over the group
    backward (every rank's copy of a replicated result feeds its own
    downstream ops)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """Differentiable SUM of ``x`` over ``group``."""
    return _AllReduceSum.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """MAX of ``x`` over ``group``, outside autograd (a stabiliser or a
    selector: callers route gradients around it)."""
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.MAX, group=group)
    return out


def preduce(v: torch.Tensor, group) -> torch.Tensor:
    """Complete a local partial sum over the node group (``group`` None:
    the node axis is not sharded and ``v`` is whole)."""
    return v if group is None else all_reduce_sum(v, group)


@dataclasses.dataclass
class ShardedCOOAdj:
    """One rank's shard of a node-partitioned batch.

    Senders are remapped into the halo-extended table: [0, n_local) are
    the owned rows, n_local + j·halo + t the t-th row received from
    shard j.  ``send_rows[j, t]`` is the owned row this rank sends to
    shard j in slot t."""

    senders: torch.Tensor       # (E_s,) int32, remapped (see above)
    receivers: torch.Tensor     # (E_s,) int32 in [0, n_local), sorted
    edge_attr: torch.Tensor     # (E_s, K) int32, 0 = hop absent
    edge_mask: torch.Tensor     # (E_s,) bool
    send_rows: torch.Tensor     # (P, B) int32
    n_local: int
    n_shards: int
    rank: int
    group: object = None        # the node axis's ProcessGroup
    # per-pair boundary sizes, row-major (i, j): rows receiver shard i
    # needs from owner shard j, before padding to the common halo B
    boundary: Tuple[int, ...] = ()
    # this rank's rectangular kernel plan (K·n_local rows over K·n_ext
    # sender rows, parallel/partition.attach_pallas_plans); hop windows
    # are its prefix slices
    plan: Optional[KHopPlan] = None
    # this rank's banded plan over the halo-extended table
    # (parallel/partition.attach_banded_plans)
    banded: Optional[BandedAdj] = None
    # (n_local + 1,) int32 CSR of the local receivers over the real edges
    # (the padded tail lies past its end), and the sums' backward rows
    # (the receivers, n_local on that tail); built at partition time
    indptr: Optional[torch.Tensor] = None
    grad_rows: Optional[torch.Tensor] = None
    # the send plan sorted once at partition time, for the halo
    # exchange's backward: send_rows.reshape(-1)[halo_order] is sorted,
    # and halo_indptr ((n_local + 1,) int32) is its CSR
    halo_order: Optional[torch.Tensor] = None
    halo_indptr: Optional[torch.Tensor] = None

    @property
    def K(self) -> int:
        return self.edge_attr.shape[1]

    @property
    def halo(self) -> int:
        return self.send_rows.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.n_local * self.n_shards

    @property
    def n_ext(self) -> int:
        """Rows of the halo-extended sender table."""
        return self.n_local + self.n_shards * self.halo

    def slice_hops(self, k: int) -> "ShardedCOOAdj":
        if k >= self.K:
            return self
        return dataclasses.replace(
            self, edge_attr=self.edge_attr[:, :k],
            plan=None if self.plan is None else self.plan.slice_hops(k),
            banded=None if self.banded is None
            else self.banded.slice_hops(k))

    def to(self, device) -> "ShardedCOOAdj":
        def move(t):
            return None if t is None else t.to(device)
        return dataclasses.replace(
            self, senders=self.senders.to(device),
            receivers=self.receivers.to(device),
            edge_attr=self.edge_attr.to(device),
            edge_mask=self.edge_mask.to(device),
            send_rows=self.send_rows.to(device),
            indptr=move(self.indptr), grad_rows=move(self.grad_rows),
            halo_order=move(self.halo_order),
            halo_indptr=move(self.halo_indptr),
            plan=None if self.plan is None else self.plan.to(device),
            banded=None if self.banded is None else self.banded.to(device))

    # --- accounting -------------------------------------------------
    def boundary_total(self) -> int:
        return sum(self.boundary)

    def comm_elems_per_layer(self, K: int, D: int) -> int:
        """Per-rank all_to_all payload (elements) of one aggregation:
        n_shards halo blocks of B rows, (K, D) each."""
        return self.n_shards * self.halo * K * D

    def psum_elems_per_layer(self, K: int, D: int) -> int:
        """What a replicate-and-psum design would move per rank: a
        reduce-scatter plus an all-gather of the full (N, K, D) output."""
        return 2 * self.n_nodes * K * D


def node_axis(adj_or_batch):
    """The process group the node axis is sharded over, or None."""
    adj = getattr(adj_or_batch, "adj", adj_or_batch)
    return adj.group if isinstance(adj, ShardedCOOAdj) else None


class _HaloExchange(torch.autograd.Function):
    """[owned | halo from shard 0 | ... | shard P-1] along ``dim``: rank i
    sends the rows send_rows[j] to shard j in one all_to_all_single.
    Backward: the halo blocks' cotangents go back the same way and are
    added into the rows they were read from, in the order ``order`` sorts
    ``rows`` into (``indptr`` the sorted rows' CSR), through the sorted
    segment sum."""

    @staticmethod
    def forward(ctx, payload, rows, order, indptr, group, dim):
        ctx.rows, ctx.group, ctx.dim = rows, group, dim
        ctx.order, ctx.indptr = order, indptr
        ctx.n_local = payload.shape[dim]
        send = payload.index_select(dim, rows).movedim(dim, 0).contiguous()
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
        return torch.cat([payload, recv.movedim(0, dim)], dim=dim)

    @staticmethod
    def backward(ctx, g):
        own, halo = g.split([ctx.n_local, g.shape[ctx.dim] - ctx.n_local],
                            dim=ctx.dim)
        halo = halo.movedim(ctx.dim, 0).contiguous()
        back = torch.empty_like(halo)
        dist.all_to_all_single(back, halo, group=ctx.group)
        added = sorted_segment_sum(back[ctx.order], ctx.rows[ctx.order],
                                   ctx.n_local, ctx.indptr)
        return (own + added.movedim(0, ctx.dim), None, None, None, None,
                None)


def halo_exchange(adj: ShardedCOOAdj, payload: torch.Tensor,
                  dim: int = 0) -> torch.Tensor:
    """Exchange boundary rows: payload with n_local rows along ``dim``
    (0 node-major, 1 hop-major) -> n_ext rows, the extended table.  One
    all_to_all moves P·B rows per rank: the whole per-layer
    communication of the sharded backend."""
    return _HaloExchange.apply(payload, adj.send_rows.reshape(-1),
                               adj.halo_order, adj.halo_indptr, adj.group,
                               dim)


def halo_plan(rows: torch.Tensor, n_local: int):
    """(the stable order that sorts the flat send plan ``rows``, the
    sorted rows' (n_local + 1,) int32 CSR): the halo exchange's backward
    sum over it adds each row's cotangents in one order."""
    order = torch.sort(rows, stable=True)[1]
    return order, segment_indptr(rows[order], n_local)


def sharded_khop_aggregate(
    adj: ShardedCOOAdj,
    x: torch.Tensor,                    # (n_local, K, D) | (K, n_local, D)
    table1: torch.Tensor,               # (V1, D)
    tablek: Optional[torch.Tensor],
    *,
    scale: Optional[torch.Tensor] = None,         # (n_local, K) receiver
    sender_scale: Optional[torch.Tensor] = None,  # (n_local, K) sender
    aggr: str = "add",
    hop_major: bool = False,
) -> torch.Tensor:
    """``khop_aggregate_adj``'s contract on one shard: senders read from
    the halo-extended table, the sums bounded to the owned rows.  The
    sender scale rides the same exchange as one more feature column.
    Local aggregation on the banded plan (without a sender scale, as in
    the JAX package), else the kernel plan, else COO."""
    from ..nn.embed import small_table_lookup, zero_row  # nn imports ops

    dim = 1 if hop_major else 0
    payload = x
    if sender_scale is not None:
        ss = sender_scale.t() if hop_major else sender_scale
        payload = torch.cat([x, ss[..., None].to(x.dtype)], dim=-1)
    ext = halo_exchange(adj, payload, dim)
    ss_ext = None
    if sender_scale is not None:
        ext, ss_ext = ext[..., :-1], ext[..., -1]
        ss_ext = ss_ext.t() if hop_major else ss_ext     # (n_ext, K)
    if adj.banded is not None and ss_ext is None:
        return banded_khop_aggregate(ext, table1, tablek, adj.banded,
                                     scale=scale, aggr=aggr,
                                     hop_major=hop_major)
    if adj.plan is not None:
        return khop_spmm(ext, table1, tablek, adj.plan, scale=scale,
                         sender_scale=ss_ext, aggr=aggr,
                         hop_major=hop_major)
    if hop_major:
        ext = ext.transpose(0, 1)
    attr = adj.edge_attr
    e_emb = small_table_lookup(zero_row(table1).to(x.dtype), attr[:, :1])
    if adj.K > 1:
        e_emb = torch.cat([e_emb, small_table_lookup(
            zero_row(tablek).to(x.dtype), attr[:, 1:])], dim=-2)
    edge_scale = None
    if scale is not None or ss_ext is not None:
        edge_scale = 1.0
        if scale is not None:
            edge_scale = scale[adj.receivers.long()]
        if ss_ext is not None:
            edge_scale = edge_scale * ss_ext[adj.senders.long()]
    out = khop_aggregate(ext, adj.senders, adj.receivers, e_emb, attr,
                         adj.edge_mask, scale=edge_scale, aggr=aggr,
                         num_segments=adj.n_local, indptr=adj.indptr,
                         grad_rows=adj.grad_rows)
    return out.transpose(0, 1) if hop_major else out


def sharded_degree(adj: ShardedCOOAdj, add_self_loop: bool = False
                   ) -> torch.Tensor:
    """(n_local, K) per-hop in-degree, purely local: every edge into an
    owned node lives in the local shard."""
    deg = segment_sum((adj.edge_attr > 0).float(), adj.receivers,
                      adj.n_local, indptr=adj.indptr)
    return deg + 1.0 if add_self_loop else deg


def sharded_union_in_degree(adj: ShardedCOOAdj) -> torch.Tensor:
    return segment_sum(adj.edge_mask.float(), adj.receivers, adj.n_local,
                       indptr=adj.indptr)
