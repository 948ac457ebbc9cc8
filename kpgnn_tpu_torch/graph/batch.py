"""Padded graph batches (counterpart of kpgnn_tpu/graph/batch.py).

A batch of ragged graphs is packed into one padded ``GraphBatch`` with the
JAX package's layout, so one list of graphs gives the same node layout in
both packages.  ``collate`` (COO) and ``collate_pallas`` (the kernel plan,
ops/spmm.py) concatenate graphs node-wise; node slot ``n_pad - 1`` and
graph slot ``g_pad - 1`` are reserved for padding, and padded nodes belong
to the masked last graph slot.  ``collate_dense`` gives graph b the node
slots [b * n_slot, (b + 1) * n_slot) and a dense hop-attr tile
(ops/adjacency.DenseAdj); there is no reserved graph slot, and padded
nodes carry their own slot's graph id.  ``collate_banded`` packs as
``collate`` does, with n_pad rounded up to the banded plan's tile
(ops/banded.py).  Masks mark real entries everywhere.  The kernel
plan's TPU-only rounding of n_pad up to a tile is gone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.adjacency import COOAdj, DenseAdj
from ..ops.banded import (BANDED_TILE, DEFAULT_HALO_CAP, HALO_ALIGN,
                          build_banded)
from ..ops.spmm import build_plan
from .data import Graph


@dataclasses.dataclass
class GraphBatch:
    """Padded batch of graphs; all tensors on one device."""

    # --- node-level (N = n_pad) ---
    x: torch.Tensor                         # (N, F) float or (N, C) int
    node_mask: torch.Tensor                 # (N,) bool
    node_graph_ids: torch.Tensor            # (N,) int64 in [0, G)
    pe_attr: Optional[torch.Tensor]         # (N, K-1) | None
    peripheral_edge_attr: Optional[torch.Tensor]    # (N, K, T, 2) | None
    peripheral_config_attr: Optional[torch.Tensor]  # (N, K, H+1) | None
    rd: Optional[torch.Tensor]              # (N, 1) float | None
    z: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    # --- adjacency backend ---
    adj: object
    # --- graph-level (G = g_pad) ---
    y: Optional[torch.Tensor]               # (G, ...) or (N, ...) target
    graph_mask: torch.Tensor                # (G,) bool

    @property
    def n_pad(self) -> int:
        return self.node_mask.shape[0]

    @property
    def g_pad(self) -> int:
        return self.graph_mask.shape[0]

    @property
    def K(self) -> int:
        return self.adj.K

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def to(self, device) -> "GraphBatch":
        kw = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            kw[f.name] = v.to(device) if v is not None else None
        return GraphBatch(**kw)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Rounds raw batch sizes up to a small set of shapes (multiples,
    escalated by powers of two above the multiple)."""

    node_multiple: int = 128
    edge_multiple: int = 512
    power_of_two: bool = True

    def round(self, n: int, multiple: int) -> int:
        n = max(n, 1)
        r = _round_up(n, multiple)
        if self.power_of_two and r > multiple:
            p = multiple
            while p < n:
                p *= 2
            r = p
        return r

    def pad_sizes(self, num_nodes: int, num_edges: int) -> Tuple[int, int]:
        return (self.round(num_nodes + 1, self.node_multiple),
                self.round(num_edges, self.edge_multiple))


def pad_sizes(graphs: Sequence[Graph], spec: Optional[BucketSpec] = None
              ) -> Tuple[int, int, int]:
    """(n_pad, e_pad, g_pad) for a list of graphs under a bucket spec."""
    spec = spec or BucketSpec()
    tot_n = sum(g.num_nodes for g in graphs)
    tot_e = sum(g.num_edges for g in graphs)
    n_pad, e_pad = spec.pad_sizes(tot_n, tot_e)
    return n_pad, e_pad, len(graphs) + 1


def _cat_nodes(graphs, field, n_pad, slot=None):
    """A node-level field, padded to n_pad rows; with ``slot`` (dense
    mode) graph b starts at row b * slot."""
    arrs = [getattr(g, field) for g in graphs]
    if any(a is None for a in arrs):
        return None
    a0 = np.asarray(arrs[0])
    out = np.zeros((n_pad,) + a0.shape[1:], dtype=a0.dtype)
    off = 0
    for b, (g, a) in enumerate(zip(graphs, arrs)):
        o = b * slot if slot is not None else off
        out[o:o + g.num_nodes] = np.asarray(a)
        off += g.num_nodes
    return out


def _collate_y(graphs, g_pad, n_pad, y_is_node_level, slot=None):
    ys = [g.y for g in graphs]
    if any(v is None for v in ys):
        return None
    if y_is_node_level:
        return _cat_nodes(graphs, "y", n_pad, slot)
    y0 = np.asarray(ys[0]).reshape(-1)
    y = np.zeros((g_pad, y0.shape[0]) if y0.shape[0] > 1 else (g_pad,),
                 dtype=y0.dtype)
    for i, g in enumerate(graphs):
        y[i] = (np.asarray(g.y).reshape(-1) if y.ndim > 1
                else np.asarray(g.y).reshape(()))
    return y


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a)) if a is not None \
        else None


def collate(
    graphs: Sequence[Graph],
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    g_pad: Optional[int] = None,
    spec: Optional[BucketSpec] = None,
    y_is_node_level: bool = False,
) -> GraphBatch:
    """COO collation: offset node indices, sort edges by receiver
    (stable), pad everything to (n_pad, e_pad, g_pad)."""
    if n_pad is None or e_pad is None or g_pad is None:
        dn, de, dg = pad_sizes(graphs, spec)
        n_pad = n_pad if n_pad is not None else dn
        e_pad = e_pad if e_pad is not None else de
        g_pad = g_pad if g_pad is not None else dg
    B = len(graphs)
    if B > g_pad:
        raise ValueError(f"batch of {B} graphs > g_pad={g_pad}")
    tot_n = sum(g.num_nodes for g in graphs)
    tot_e = sum(g.num_edges for g in graphs)
    if tot_n > n_pad - 1 or tot_e > e_pad:
        raise ValueError(
            f"batch needs {tot_n}+1 node / {tot_e} edge slots, "
            f"got n_pad={n_pad}, e_pad={e_pad}")

    K = graphs[0].K
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_mask[:tot_n] = True
    node_graph_ids = np.full((n_pad,), g_pad - 1, dtype=np.int64)
    senders = np.zeros((e_pad,), dtype=np.int32)
    receivers = np.full((e_pad,), n_pad - 1, dtype=np.int32)
    edge_attr = np.zeros((e_pad, K), dtype=np.int32)
    edge_mask = np.zeros((e_pad,), dtype=bool)
    off_n, off_e = 0, 0
    for i, g in enumerate(graphs):
        e = g.num_edges
        node_graph_ids[off_n:off_n + g.num_nodes] = i
        senders[off_e:off_e + e] = g.edge_index[0] + off_n
        receivers[off_e:off_e + e] = g.edge_index[1] + off_n
        edge_attr[off_e:off_e + e] = np.asarray(g.edge_attr).reshape(e, K)
        edge_mask[off_e:off_e + e] = True
        off_n += g.num_nodes
        off_e += e
    order = np.argsort(receivers[:off_e], kind="stable")
    senders[:off_e] = senders[:off_e][order]
    receivers[:off_e] = receivers[:off_e][order]
    edge_attr[:off_e] = edge_attr[:off_e][order]
    graph_mask = np.zeros((g_pad,), dtype=bool)
    graph_mask[:B] = True

    # the receivers' CSR over the real edges: the padded tail (all into
    # node n_pad - 1) lies past indptr[n_pad], outside every node's range,
    # and takes the zero gradient row n_pad
    indptr = np.searchsorted(receivers[:off_e], np.arange(n_pad + 1))
    grad_rows = receivers.copy()
    grad_rows[off_e:] = n_pad
    adj = COOAdj(senders=_t(senders), receivers=_t(receivers),
                 edge_attr=_t(edge_attr), edge_mask=_t(edge_mask),
                 n_nodes=n_pad, indptr=_t(indptr.astype(np.int32)),
                 grad_rows=_t(grad_rows))
    return _finish(graphs, adj, n_pad, g_pad, node_mask, node_graph_ids,
                   graph_mask, y_is_node_level)


def _finish(graphs, adj, n_pad, g_pad, node_mask, node_graph_ids,
            graph_mask, y_is_node_level, slot=None) -> GraphBatch:
    """The batch around an adjacency: every node-level field padded to
    n_pad rows (graph b at row b * slot in dense mode), y and the
    masks."""
    def nodes(field):
        return _t(_cat_nodes(graphs, field, n_pad, slot))
    return GraphBatch(
        x=nodes("x"), node_mask=_t(node_mask),
        node_graph_ids=_t(node_graph_ids), pe_attr=nodes("pe_attr"),
        peripheral_edge_attr=nodes("peripheral_edge_attr"),
        peripheral_config_attr=nodes("peripheral_config_attr"),
        rd=nodes("rd"), z=nodes("z"), pos=nodes("pos"), adj=adj,
        y=_t(_collate_y(graphs, g_pad, n_pad, y_is_node_level, slot)),
        graph_mask=_t(graph_mask))


def collate_dense(
    graphs: Sequence[Graph],
    n_slot: int,
    v1: int,
    vk: int,
    g_pad: Optional[int] = None,
    y_is_node_level: bool = False,
) -> GraphBatch:
    """Dense collation (``--backend dense``): graph b takes node slots
    [b * n_slot, (b + 1) * n_slot) and its (K, n_slot, n_slot) hop-attr
    tile; g_pad defaults to the number of graphs, with no reserved pad
    slot.  v1/vk are the hop-1 / hop-k attr vocab sizes (num_hop1_edge +
    2 and max_pe_num + 2) of the code histograms."""
    B = len(graphs)
    g_pad = g_pad if g_pad is not None else B
    if B > g_pad:
        raise ValueError(f"batch of {B} graphs > g_pad={g_pad}")
    K = graphs[0].K
    for g in graphs:
        if g.num_nodes > n_slot:
            raise ValueError(f"graph with {g.num_nodes} nodes > "
                             f"n_slot={n_slot}")
    n_pad = g_pad * n_slot
    hop_attr = np.zeros((g_pad, K, n_slot, n_slot), dtype=np.int32)
    node_mask = np.zeros((n_pad,), dtype=bool)
    node_graph_ids = np.repeat(np.arange(g_pad, dtype=np.int64), n_slot)
    for b, g in enumerate(graphs):
        node_mask[b * n_slot:b * n_slot + g.num_nodes] = True
        if g.num_edges:
            u, v = g.edge_index[0], g.edge_index[1]
            ea = np.asarray(g.edge_attr).reshape(g.num_edges, K)
            for k in range(K):              # [k, i, j]: edge j -> i
                hop_attr[b, k, v, u] = ea[:, k]
    graph_mask = np.zeros((g_pad,), dtype=bool)
    graph_mask[:B] = True
    adj = DenseAdj.from_codes(_t(hop_attr), v1, vk)
    return _finish(graphs, adj, n_pad, g_pad, node_mask, node_graph_ids,
                   graph_mask, y_is_node_level, slot=n_slot)


def collate_pallas(
    graphs: Sequence[Graph],
    v1: int,
    vk: int,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    g_pad: Optional[int] = None,
    spec: Optional[BucketSpec] = None,
    y_is_node_level: bool = False,
) -> GraphBatch:
    """COO collation whose adjacency is the fused-hop kernel plan
    (``--backend pallas``).  v1/vk are the hop-1 / hop-k attr vocab sizes
    (num_hop1_edge + 2 and max_pe_num + 2).  Without n_pad or spec the
    node axis rounds to a multiple of 128 without power-of-two
    escalation, as the JAX collate_pallas does for its default tile."""
    if n_pad is None and spec is None:
        spec = BucketSpec(power_of_two=False)
    batch = collate(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                    spec=spec, y_is_node_level=y_is_node_level)
    coo = batch.adj
    em = coo.edge_mask.numpy()
    plan = build_plan(coo.receivers.numpy()[em], coo.senders.numpy()[em],
                      coo.edge_attr.numpy()[em], coo.n_nodes, v1, vk)
    return batch.replace(adj=plan)


def collate_banded(
    graphs: Sequence[Graph],
    v1: int,
    vk: int,
    n_pad: Optional[int] = None,
    e_pad: Optional[int] = None,
    g_pad: Optional[int] = None,
    spec: Optional[BucketSpec] = None,
    y_is_node_level: bool = False,
    tile: Optional[int] = None,
    halo: Optional[int] = None,
    spill_pad: Optional[int] = None,
    gcn_norm: bool = False,
) -> GraphBatch:
    """COO collation whose adjacency is a banded window plan
    (``--backend banded``, ops/banded.py), for large, locally ordered
    graphs.  The halo auto-sizes to the batch's edge reach and edges
    beyond it spill to a COO side list, so any graph runs.

    Without ``tile``: 128 when the halo (``halo``, or the batch's edge
    span rounded up to HALO_ALIGN and capped) is at most 128, else 256
    (win = tile + 2·halo, so the smaller tile multiplies fewer window
    rows).  n_pad is rounded up to the tile.  ``gcn_norm`` folds KPGCN's
    sender scale (deg + 1)^-0.5 per hop, the self loop included, into
    the plan.  Loaders pin ``halo`` and ``spill_pad`` to the dataset's
    worst case so that every batch has one shape."""
    if tile is None:
        if halo is not None:
            h_est = halo
        else:
            span = 0
            for g in graphs:
                if g.num_edges:
                    span = max(span, int(np.abs(
                        g.edge_index[0].astype(np.int64)
                        - g.edge_index[1]).max()))
            h_est = min(-(-span // HALO_ALIGN) * HALO_ALIGN,
                        DEFAULT_HALO_CAP)
        tile = 128 if h_est <= 128 else BANDED_TILE
    if n_pad is not None:
        n_pad = _round_up(n_pad, tile)
    elif spec is not None:
        spec = dataclasses.replace(spec, node_multiple=tile)
    else:
        spec = BucketSpec(node_multiple=tile, power_of_two=False)
    batch = collate(graphs, n_pad=n_pad, e_pad=e_pad, g_pad=g_pad,
                    spec=spec, y_is_node_level=y_is_node_level)
    coo = batch.adj
    em = coo.edge_mask.numpy()
    recv = coo.receivers.numpy()[em]
    send = coo.senders.numpy()[em]
    attr = coo.edge_attr.numpy()[em]
    sw = None
    if gcn_norm:
        sw = gcn_sender_weights(recv, attr, coo.n_nodes)
    adj = build_banded(recv, send, attr, coo.n_nodes, v1, vk, tile=tile,
                       halo=halo, spill_pad=spill_pad, sender_weights=sw)
    return batch.replace(adj=adj)


def gcn_sender_weights(receivers: np.ndarray, attr: np.ndarray,
                       n_nodes: int) -> np.ndarray:
    """(n_nodes, K) KPGCN's structural sender scale (deg + 1)^-0.5 per
    hop, the self loop included (``degree(adj, add_self_loop=True)``)."""
    K = attr.shape[1]
    deg = np.ones((n_nodes, K), np.float32)
    for k in range(K):
        np.add.at(deg[:, k], receivers[attr[:, k] > 0], 1.0)
    return 1.0 / np.sqrt(deg)
