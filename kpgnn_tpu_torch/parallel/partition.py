"""Node-partitioned ("graph parallel") training over a process group
(counterpart of kpgnn_tpu/parallel/partition.py).

A collated batch is partitioned by node range: rank i owns the node
slots [i·n_local, (i+1)·n_local), the span of receiver-sorted edges
pointing into them, and the output rows it produces.  Per layer the only
communication is one all_to_all of boundary rows (the halo plan built
here; the device side is ops/sharded_adjacency.py) plus the small
all-reduces of per-graph statistics.  Every rank computes the whole plan
on the host (its send rows are other shards' boundaries) and keeps its
own shard; with ``pallas`` it builds its own rectangular kernel plan
(K·n_local rows over K·n_ext sender rows), with ``banded`` its own
banded plan over the halo-extended table.  The JAX package stacks the
shards and pads them to common statics for ``shard_map``; one process
per rank needs neither.

The gradient rule (the module docstring of ops/sharded_adjacency.py):
each rank backpropagates loss / P through the differentiable
all-reduces and the halo exchange, then the parameter gradients are
summed over the group.  Parameters, optimizer state and batch-norm
running statistics stay equal on every rank.  The dropout generator is
the same on every rank: graph-level values are replicated, and a
rank-dependent mask would make them differ (masks repeat across shards
at equal local positions, as in the JAX step).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..graph.batch import GraphBatch
from ..ops.adjacency import COOAdj
from ..ops.banded import BANDED_TILE, build_banded
from ..ops.sharded_adjacency import ShardedCOOAdj, all_reduce_sum, halo_plan
from ..ops.spmm import build_plan
from ..train.loop import _batch_target_mask, _masked_loss, eval_step
from .dp import all_reduce_sums, reduce_gradients
from .mesh import Mesh

NODE_FIELDS = ("x", "node_mask", "node_graph_ids", "pe_attr",
               "peripheral_edge_attr", "peripheral_config_attr", "rd", "z",
               "pos")


def _round_up(v: int, m: int) -> int:
    return ((v + m - 1) // m) * m


def partition_adj(adj: COOAdj, n_shards: int, rank: int,
                  group=None) -> ShardedCOOAdj:
    """Host-side partition plan, shard ``rank`` of it: node slots split
    into ``n_shards`` equal contiguous ranges, the receiver-sorted edges
    into the matching spans (padded to a common length with masked edges,
    the JAX package's arrays), boundary senders deduplicated per shard
    pair into the all_to_all send plan and the edge senders remapped into
    the [local | halo] extended table.  Batches whose graphs align with
    the shard boundaries get an empty boundary: the exchange then carries
    one padding row a pair."""
    if not isinstance(adj, COOAdj):
        raise ValueError("partition_adj needs the COO backend")
    n_pad = adj.n_nodes
    if n_pad % n_shards:
        raise ValueError(f"n_nodes={n_pad} not divisible by {n_shards} "
                         "(collate with node_multiple >= n_shards)")
    n_local = n_pad // n_shards
    receivers = adj.receivers.numpy()
    emask = adj.edge_mask.numpy()
    # masked (padding) edges contribute nothing: point their senders at
    # the receiving shard so they never make halo traffic
    senders = np.where(emask, adj.senders.numpy(), receivers)
    attr = adj.edge_attr.numpy()
    K = attr.shape[1]

    bounds = np.arange(n_shards + 1) * n_local
    spans = np.searchsorted(receivers, bounds)
    e_shard = max(8, _round_up(int(np.max(np.diff(spans))), 8))
    uniq = [[np.empty(0, np.int64)] * n_shards for _ in range(n_shards)]
    for i in range(n_shards):
        s = senders[spans[i]:spans[i + 1]]
        owner = s // n_local
        for j in range(n_shards):
            if j != i:
                uniq[i][j] = np.unique(s[owner == j])
    halo = max(1, max((len(u) for row in uniq for u in row), default=1))
    boundary = tuple(len(uniq[i][j]) for i in range(n_shards)
                     for j in range(n_shards))

    i = rank
    send_rows = np.zeros((n_shards, halo), np.int32)
    for j in range(n_shards):
        u = uniq[j][i]                  # what shard j needs from rank i
        send_rows[j, :len(u)] = u - i * n_local
    lo, hi = spans[i], spans[i + 1]
    e = hi - lo
    s = senders[lo:hi].astype(np.int64)
    owner = s // n_local
    s_new = s - i * n_local
    for j in range(n_shards):
        u = uniq[i][j]
        if j == i or not len(u):
            continue
        sel = owner == j
        s_new[sel] = n_local + j * halo + np.searchsorted(u, s[sel])
    S = np.zeros(e_shard, np.int32)
    # pad receivers with the LAST local slot: real receivers stay sorted
    R = np.full(e_shard, n_local - 1, np.int32)
    A = np.zeros((e_shard, K), np.int32)
    M = np.zeros(e_shard, bool)
    S[:e] = s_new
    R[:e] = receivers[lo:hi] - i * n_local
    A[:e] = attr[lo:hi]
    M[:e] = emask[lo:hi]
    # the receivers' CSR ends at the last real edge: the padded tail (into
    # the last local slot) lies outside every row's range
    real = int(np.flatnonzero(M)[-1]) + 1 if M.any() else 0
    indptr = np.searchsorted(R[:real], np.arange(n_local + 1))
    grad_rows = R.copy()
    grad_rows[real:] = n_local
    order, halo_indptr = halo_plan(torch.from_numpy(send_rows).reshape(-1),
                                   n_local)
    return ShardedCOOAdj(
        senders=torch.from_numpy(S), receivers=torch.from_numpy(R),
        edge_attr=torch.from_numpy(A), edge_mask=torch.from_numpy(M),
        send_rows=torch.from_numpy(send_rows), n_local=n_local,
        n_shards=n_shards, rank=rank, group=group, boundary=boundary,
        indptr=torch.from_numpy(indptr.astype(np.int32)),
        grad_rows=torch.from_numpy(grad_rows), halo_order=order,
        halo_indptr=halo_indptr)


def _live_edges(adj: ShardedCOOAdj):
    m = adj.edge_mask.numpy()
    return (adj.receivers.numpy()[m], adj.senders.numpy()[m],
            adj.edge_attr.numpy()[m])


def attach_pallas_plans(adj: ShardedCOOAdj, v1: int, vk: int
                        ) -> ShardedCOOAdj:
    """This rank's rectangular kernel plan: receivers the owned rows,
    senders the halo-extended table (kernel rows K·n_local over K·n_ext
    sender rows; the backward is the transpose).  Every union edge is
    passed, so the union in-degree (the mean's denominator) counts them
    all.  A hop window k (GNNPlus's slice_hops) is the plan's prefix of
    k hops, the same plan the JAX package builds per window."""
    r, s, a = _live_edges(adj)
    plan = build_plan(r, s, a, adj.n_local, v1, vk, n_cols_nodes=adj.n_ext)
    return dataclasses.replace(adj, plan=plan)


def attach_banded_plans(adj: ShardedCOOAdj, v1: int, vk: int,
                        tile: Optional[int] = None,
                        halo: Optional[int] = None) -> ShardedCOOAdj:
    """This rank's banded plan over the halo-extended table: in-shard
    edges of a bandwidth-ordered graph land in the windows, every
    cross-shard edge (a sender at a halo row >= n_local) spills, which is
    O(boundary) edges."""
    if tile is None:
        tile = math.gcd(adj.n_local, BANDED_TILE)
        if tile < 32:
            # a degenerate tile caps the halo at tile rows and spills
            # nearly every edge: a slower COO in a banded costume
            raise ValueError(
                f"auto tile gcd(n_local={adj.n_local}, {BANDED_TILE}) = "
                f"{tile} is too small to be useful; collate with "
                "node_multiple = n_shards * 256 (or pass an explicit tile "
                "that divides n_local)")
    if adj.n_local % tile:
        raise ValueError(
            f"n_local={adj.n_local} must divide by tile={tile} for the "
            "sharded banded path (collate with node_multiple = "
            "n_shards * tile)")
    r, s, a = _live_edges(adj)
    banded = build_banded(r, s, a, adj.n_local, v1, vk, tile=tile,
                          halo=halo, n_cols=adj.n_ext)
    return dataclasses.replace(adj, banded=banded)


def partition_batch(batch: GraphBatch, n_shards: int, rank: int,
                    group=None, node_level: bool = False,
                    pallas: Optional[dict] = None,
                    banded: Optional[dict] = None) -> GraphBatch:
    """Shard ``rank`` of a collated COO batch: its node rows (and, for a
    node-level target, its rows of y), the whole per-graph arrays, and
    the sharded adjacency; ``pallas`` ({"v1", "vk"}) or ``banded``
    ({"v1", "vk"[, "tile", "halo"]}) attach this rank's local plan."""
    adj = partition_adj(batch.adj, n_shards, rank, group)
    if pallas is not None:
        adj = attach_pallas_plans(adj, **pallas)
    if banded is not None:
        adj = attach_banded_plans(adj, **banded)
    rows = slice(rank * adj.n_local, (rank + 1) * adj.n_local)
    kw = {f: getattr(batch, f)[rows] for f in NODE_FIELDS
          if getattr(batch, f) is not None}
    if node_level and batch.y is not None:
        kw["y"] = batch.y[rows]
    # the whole batch's graph CSR indexes rows this shard does not hold
    return batch.replace(adj=adj, graph_indptr=None, **kw)


def partition_loader(loader, n_shards: int, rank: int, group=None,
                     node_level: bool = False,
                     pallas: Optional[dict] = None,
                     banded: Optional[dict] = None):
    """Wrap a COO loader's stream, partitioning every batch."""
    for b in loader:
        yield partition_batch(b, n_shards, rank, group, node_level,
                              pallas=pallas, banded=banded)


class PartitionedLoader:
    """Re-iterable node-partitioned view of a loader (what the Trainer
    evaluates every epoch).  Deterministic loaders are partitioned once
    and replayed; shuffled ones re-partition each epoch."""

    def __init__(self, loader, n_shards: int, rank: int, group=None,
                 node_level: bool = False, pallas: Optional[dict] = None,
                 banded: Optional[dict] = None):
        self.loader = loader
        self.kw = dict(n_shards=n_shards, rank=rank, group=group,
                       node_level=node_level, pallas=pallas, banded=banded)
        self._cache = None

    def __iter__(self):
        if getattr(self.loader, "shuffle", True):
            return partition_loader(self.loader, **self.kw)
        if self._cache is None:
            self._cache = list(partition_loader(self.loader, **self.kw))
        return iter(self._cache)


def sharded_train_step(model, opt, batch: GraphBatch, loss: str = "l1",
                       generator: Optional[torch.Generator] = None,
                       node_level: bool = False, *, mesh: Mesh,
                       axis: Optional[str] = None):
    """One node-sharded optimizer step on this rank's shard
    (``loop.train_step``'s signature).  A graph-level loss is replicated
    already; a node-level one is summed over the group.  Each rank
    backpropagates loss / P, then the gradients are summed over the
    group.  Returns (loss sum, count) of the whole batch."""
    axis = axis or mesh.axis_names[0]
    group = mesh.group(axis)
    pred = model(batch, train=True, generator=generator)
    lsum, cnt = _masked_loss(pred, batch.y,
                             _batch_target_mask(batch, node_level), loss)
    if node_level:
        lsum = all_reduce_sum(lsum, group)
        cnt = mesh.all_reduce(cnt.detach().clone(), axis)
    opt.zero_grad(set_to_none=True)
    (lsum / torch.clamp(cnt, min=1.0) / mesh.axis_size(axis)).backward()
    reduce_gradients(model, mesh, axis)
    opt.step()
    return lsum.detach(), cnt.detach()


def make_sharded_train_step(mesh: Mesh, axis: Optional[str] = None):
    """``sharded_train_step`` bound to ``mesh``: a ``loop.train_step``
    for ``loop.train_epoch``."""
    return functools.partial(sharded_train_step, mesh=mesh, axis=axis)


def sharded_eval_step(model, batch: GraphBatch, loss: str = "l1",
                      metric: str = "same", node_level: bool = False,
                      bn_train_mode: bool = False, *, mesh: Mesh,
                      axis: Optional[str] = None) -> dict:
    """``loop.eval_step`` on this rank's shard: node-level sums are summed
    over the group, graph-level ones are replicated already."""
    out = eval_step(model, batch, loss, metric, node_level, bn_train_mode)
    return all_reduce_sums(out, mesh, axis) if node_level else out


def make_sharded_eval_step(mesh: Mesh, axis: Optional[str] = None):
    return functools.partial(sharded_eval_step, mesh=mesh, axis=axis)
