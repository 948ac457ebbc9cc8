"""Padded graph batches (counterpart of kpgnn_tpu/graph/batch.py).

A batch of ragged graphs is packed into one padded ``GraphBatch`` with the
JAX package's layout, so one list of graphs gives the same node layout in
both packages: graphs are concatenated node-wise, node slot ``n_pad - 1``
and graph slot ``g_pad - 1`` are reserved for padding, and padded nodes
belong to the masked last graph slot.  Masks mark real entries everywhere.

``collate`` gives a receiver-sorted COO edge list; ``collate_pallas``
turns it into the kernel plan (ops/spmm.py), the adjacency this slice
trains on.  The TPU-only rounding of n_pad up to a kernel tile is gone.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.adjacency import COOAdj
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


def _cat_nodes(graphs, field, n_pad):
    arrs = [getattr(g, field) for g in graphs]
    if any(a is None for a in arrs):
        return None
    a0 = np.asarray(arrs[0])
    out = np.zeros((n_pad,) + a0.shape[1:], dtype=a0.dtype)
    off = 0
    for g, a in zip(graphs, arrs):
        out[off:off + g.num_nodes] = np.asarray(a)
        off += g.num_nodes
    return out


def _collate_y(graphs, g_pad, n_pad, y_is_node_level):
    ys = [g.y for g in graphs]
    if any(v is None for v in ys):
        return None
    y0 = np.asarray(ys[0])
    if y_is_node_level:
        y = np.zeros((n_pad,) + y0.shape[1:], dtype=y0.dtype)
        off = 0
        for g in graphs:
            y[off:off + g.num_nodes] = np.asarray(g.y)
            off += g.num_nodes
        return y
    y0 = y0.reshape(-1)
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

    adj = COOAdj(senders=_t(senders), receivers=_t(receivers),
                 edge_attr=_t(edge_attr), edge_mask=_t(edge_mask),
                 n_nodes=n_pad)
    return GraphBatch(
        x=_t(_cat_nodes(graphs, "x", n_pad)),
        node_mask=_t(node_mask),
        node_graph_ids=_t(node_graph_ids),
        pe_attr=_t(_cat_nodes(graphs, "pe_attr", n_pad)),
        peripheral_edge_attr=_t(_cat_nodes(graphs, "peripheral_edge_attr",
                                           n_pad)),
        peripheral_config_attr=_t(_cat_nodes(
            graphs, "peripheral_config_attr", n_pad)),
        rd=_t(_cat_nodes(graphs, "rd", n_pad)),
        z=_t(_cat_nodes(graphs, "z", n_pad)),
        pos=_t(_cat_nodes(graphs, "pos", n_pad)),
        adj=adj,
        y=_t(_collate_y(graphs, g_pad, n_pad, y_is_node_level)),
        graph_mask=_t(graph_mask),
    )


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
