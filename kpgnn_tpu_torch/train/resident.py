"""Device-resident datasets and resident epochs (counterpart of
kpgnn_tpu/train/resident.py, the dense, COO and banded stores).

The whole prepped dataset goes to the device once, as per-graph padded
tensors with a leading graph axis.  An epoch then sends one (steps, B)
index array; each step gathers its batch on the device from one index
row and runs the per-batch path's train step (``loop.train_step``) on
it, so no step collates on the host or copies a batch to the device.
The last slot of every store is an empty pad graph (all masks false):
the indices that pad the trailing partial batch point at it, which
reproduces the per-batch loader's masked padding.  The JAX package runs
the epoch as one ``lax.scan``; here the steps are eager, and their
static shapes (every batch of a store has the same tensors) are what a
CUDA graph of the step would need.

Data-parallel resident epochs (``make_parallel_resident_train_epoch``):
every rank holds the whole store and, at each step, gathers its own
column of the (steps, P, B) index array and takes the data-parallel step
(parallel/dp.py) on it; the only per-epoch traffic is the index array.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..graph.batch import GraphBatch, gcn_sender_weights
from ..graph.data import Graph
from ..ops.adjacency import COOAdj, DenseAdj
from ..ops.banded import (BANDED_TILE, DEFAULT_HALO_CAP, HALO_ALIGN,
                          BandedAdj, build_banded)
from .loop import evaluate, train_epoch

NODE_FIELDS = ("x", "pe_attr", "peripheral_edge_attr",
               "peripheral_config_attr", "rd", "z", "pos")


@dataclasses.dataclass
class DenseStore:
    """Per-graph dense tensors, leading dim Gs = num_graphs + 1: hop attr
    codes (Gs, K, n, n) int16 ([k, i, j]: edge j -> i), the node fields
    (Gs, n, ...), node_mask (Gs, n), graph_valid (Gs,), y (Gs, ...) or
    (Gs, n, ...)."""

    hop16: torch.Tensor
    x: Optional[torch.Tensor]
    node_mask: torch.Tensor
    graph_valid: torch.Tensor
    pe_attr: Optional[torch.Tensor]
    peripheral_edge_attr: Optional[torch.Tensor]
    peripheral_config_attr: Optional[torch.Tensor]
    rd: Optional[torch.Tensor]
    z: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    v1: int
    vk: int
    y_is_node_level: bool = False

    @property
    def num_graphs(self) -> int:          # real graphs (excl. pad slot)
        return self.hop16.shape[0] - 1

    @property
    def n_slot(self) -> int:
        return self.hop16.shape[-1]

    def nbytes(self) -> int:
        return _nbytes(self)


@dataclasses.dataclass
class COOStore:
    """Per-graph padded COO tensors, leading dim Gs = num_graphs + 1:
    each graph's union edges, receiver-sorted, with local node ids in
    [0, n_slot), padded to e_slot edges whose attrs are all 0 (their
    messages vanish, as collate's padding does)."""

    senders: torch.Tensor                 # (Gs, E) int32 local ids
    receivers: torch.Tensor               # (Gs, E) int32 local ids
    edge_attr16: torch.Tensor             # (Gs, E, K) int16 attr codes
    edge_mask: torch.Tensor               # (Gs, E) bool
    x: Optional[torch.Tensor]
    node_mask: torch.Tensor
    graph_valid: torch.Tensor
    pe_attr: Optional[torch.Tensor]
    peripheral_edge_attr: Optional[torch.Tensor]
    peripheral_config_attr: Optional[torch.Tensor]
    rd: Optional[torch.Tensor]
    z: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    y_is_node_level: bool = False

    @property
    def num_graphs(self) -> int:
        return self.senders.shape[0] - 1

    @property
    def n_slot(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def e_slot(self) -> int:
        return self.senders.shape[1]

    def nbytes(self) -> int:
        return _nbytes(self)


def _nbytes(store) -> int:
    """Bytes the store's tensors hold on the device."""
    return sum(t.numel() * t.element_size()
               for t in vars(store).values() if isinstance(t, torch.Tensor))


def _field_bytes(graphs: Sequence[Graph], n_slot: int,
                 y_is_node_level: bool) -> int:
    """Bytes per graph slot of the node fields, y and the masks, at the
    dtypes the store keeps."""
    g = graphs[0]
    per = n_slot + 1                                    # node_mask, valid
    for f in NODE_FIELDS + ("y",):
        a = getattr(g, f, None)
        if a is None:
            continue
        a = np.asarray(a)
        if f == "y" and not y_is_node_level:
            per += a.nbytes
        else:
            per += a.itemsize * n_slot * int(np.prod(a.shape[1:],
                                                     dtype=np.int64))
    return per


def store_nbytes(graphs: Sequence[Graph], n_slot: int,
                 y_is_node_level: bool = False) -> int:
    """A DenseStore's device bytes, counted at the stored dtypes (the JAX
    estimate counts every field at 4 bytes and leaves out y and the
    masks)."""
    return (len(graphs) + 1) * (2 * graphs[0].K * n_slot * n_slot
                                + _field_bytes(graphs, n_slot,
                                               y_is_node_level))


def coo_store_nbytes(graphs: Sequence[Graph], n_slot: int, e_slot: int,
                     y_is_node_level: bool = False) -> int:
    """A COOStore's device bytes, counted at the stored dtypes."""
    per = e_slot * (4 + 4 + 1 + 2 * graphs[0].K)   # senders/recv/mask/attr
    return (len(graphs) + 1) * (per + _field_bytes(graphs, n_slot,
                                                   y_is_node_level))


def _stack_node_fields(graphs: Sequence[Graph], n_slot: int):
    """node_mask and graph_valid over Gs = len(graphs) + 1 slots, and a
    function stacking a node-level field into (Gs, n_slot, ...), or None
    where a graph lacks it."""
    Gs = len(graphs) + 1
    node_mask = np.zeros((Gs, n_slot), dtype=bool)
    for i, g in enumerate(graphs):
        if g.num_nodes > n_slot:
            raise ValueError(f"graph with {g.num_nodes} nodes > "
                             f"n_slot={n_slot}")
        node_mask[i, :g.num_nodes] = True

    def stack_nodes(field):
        arrs = [getattr(g, field) for g in graphs]
        if any(a is None for a in arrs):
            return None
        a0 = np.asarray(arrs[0])
        out = np.zeros((Gs, n_slot) + a0.shape[1:], dtype=a0.dtype)
        for i, (g, a) in enumerate(zip(graphs, arrs)):
            out[i, :g.num_nodes] = np.asarray(a)
        return out

    graph_valid = np.zeros((Gs,), dtype=bool)
    graph_valid[:len(graphs)] = True
    return node_mask, graph_valid, stack_nodes


def _stack_y(graphs: Sequence[Graph], n_slot: int, y_is_node_level: bool):
    ys = [g.y for g in graphs]
    if any(v is None for v in ys):
        return None
    Gs = len(graphs) + 1
    y0 = np.asarray(ys[0])
    if y_is_node_level:
        y = np.zeros((Gs, n_slot) + y0.shape[1:], dtype=y0.dtype)
        for i, g in enumerate(graphs):
            y[i, :g.num_nodes] = np.asarray(g.y)
        return y
    y0 = y0.reshape(-1)
    y = np.zeros((Gs, y0.shape[0]) if y0.shape[0] > 1 else (Gs,),
                 dtype=y0.dtype)
    for i, g in enumerate(graphs):
        y[i] = (np.asarray(g.y).reshape(-1) if y.ndim > 1
                else np.asarray(g.y).reshape(()))
    return y


def _tensors(device, **arrays):
    return {k: None if a is None else torch.from_numpy(
        np.ascontiguousarray(a)).to(device) for k, a in arrays.items()}


def build_dense_store(graphs: Sequence[Graph], n_slot: int, v1: int,
                      vk: int, y_is_node_level: bool = False,
                      device="cpu") -> DenseStore:
    """The dataset as one DenseStore on ``device`` (one copy)."""
    Gs = len(graphs) + 1
    K = graphs[0].K
    hop16 = np.zeros((Gs, K, n_slot, n_slot), dtype=np.int16)
    node_mask, graph_valid, stack_nodes = _stack_node_fields(graphs, n_slot)
    for i, g in enumerate(graphs):
        if g.num_edges:
            u, v = g.edge_index[0], g.edge_index[1]
            ea = np.asarray(g.edge_attr).reshape(g.num_edges, K)
            for k in range(K):
                hop16[i, k, v, u] = ea[:, k]
    t = _tensors(device, hop16=hop16, node_mask=node_mask,
                 graph_valid=graph_valid,
                 y=_stack_y(graphs, n_slot, y_is_node_level),
                 **{f: stack_nodes(f) for f in NODE_FIELDS})
    return DenseStore(**t, v1=v1, vk=vk, y_is_node_level=y_is_node_level)


def build_coo_store(graphs: Sequence[Graph], n_slot: Optional[int] = None,
                    e_slot: Optional[int] = None,
                    y_is_node_level: bool = False,
                    device="cpu") -> COOStore:
    """The dataset as one COOStore on ``device``; slots default to the
    largest graph's nodes and edges.  Each graph's edges are sorted by
    local receiver (stable), so a gathered batch is receiver-sorted
    within each graph's block."""
    Gs = len(graphs) + 1
    K = graphs[0].K
    n_slot = n_slot if n_slot is not None else max(g.num_nodes
                                                   for g in graphs)
    e_slot = e_slot if e_slot is not None else max(g.num_edges
                                                   for g in graphs)
    senders = np.zeros((Gs, e_slot), dtype=np.int32)
    receivers = np.zeros((Gs, e_slot), dtype=np.int32)
    edge_attr = np.zeros((Gs, e_slot, K), dtype=np.int16)
    edge_mask = np.zeros((Gs, e_slot), dtype=bool)
    for i, g in enumerate(graphs):
        e = g.num_edges
        if e > e_slot:
            raise ValueError(f"graph with {e} edges > e_slot={e_slot}")
        if e:
            u = np.asarray(g.edge_index[0], np.int32)
            v = np.asarray(g.edge_index[1], np.int32)
            order = np.argsort(v, kind="stable")
            senders[i, :e] = u[order]
            receivers[i, :e] = v[order]
            edge_attr[i, :e] = np.asarray(g.edge_attr).reshape(e, K)[order]
            edge_mask[i, :e] = True
    node_mask, graph_valid, stack_nodes = _stack_node_fields(graphs, n_slot)
    t = _tensors(device, senders=senders, receivers=receivers,
                 edge_attr16=edge_attr, edge_mask=edge_mask,
                 node_mask=node_mask, graph_valid=graph_valid,
                 y=_stack_y(graphs, n_slot, y_is_node_level),
                 **{f: stack_nodes(f) for f in NODE_FIELDS})
    return COOStore(**t, y_is_node_level=y_is_node_level)


def _batch(store, idx: torch.Tensor, adj) -> GraphBatch:
    """The GraphBatch of the graphs at ``idx`` around ``adj``: graph b
    owns node slots [b * n_slot, (b + 1) * n_slot), every node carries
    its slot's graph id (padding included), pad-slot indices are masked
    graphs."""
    B, n = idx.shape[0], store.n_slot

    def flat(a):
        return None if a is None else a[idx].reshape((B * n,) + a.shape[2:])
    y = store.y
    if y is not None:
        y = flat(y) if store.y_is_node_level else y[idx]
    return GraphBatch(
        x=flat(store.x), node_mask=flat(store.node_mask),
        node_graph_ids=torch.arange(B, device=idx.device
                                    ).repeat_interleave(n),
        pe_attr=flat(store.pe_attr),
        peripheral_edge_attr=flat(store.peripheral_edge_attr),
        peripheral_config_attr=flat(store.peripheral_config_attr),
        rd=flat(store.rd), z=flat(store.z), pos=flat(store.pos), adj=adj,
        y=y, graph_mask=store.graph_valid[idx])


def gather_batch(store: DenseStore, idx: torch.Tensor) -> GraphBatch:
    """On-device batch assembly: exactly ``collate_dense``'s batch of the
    graphs at ``idx`` with g_pad = len(idx) (pad-slot indices become
    masked graph slots)."""
    adj = DenseAdj.from_codes(store.hop16[idx], store.v1, store.vk)
    return _batch(store, idx, adj)


def gather_coo_batch(store: COOStore, idx: torch.Tensor) -> GraphBatch:
    """On-device COO batch assembly: node slots as in dense mode, edge
    ids offset by b * n_slot.  Padded edges keep all-zero attrs and a
    false edge_mask, so they add nothing; their endpoints lie inside the
    owning slot, which the masked norms and pools ignore."""
    B, n = idx.shape[0], store.n_slot
    offs = (torch.arange(B, device=idx.device, dtype=torch.int32)
            * n)[:, None]
    adj = COOAdj(
        senders=(store.senders[idx] + offs).reshape(-1),
        receivers=(store.receivers[idx] + offs).reshape(-1),
        edge_attr=store.edge_attr16[idx].int().reshape(B * store.e_slot,
                                                       -1),
        edge_mask=store.edge_mask[idx].reshape(-1), n_nodes=B * n)
    return _batch(store, idx, adj)


@dataclasses.dataclass
class BandedStore:
    """Per-graph banded plans, leading dim Gs = num_graphs + 1: the
    resident store of the large-graph regime.

    Every graph's plan shares (tile, halo, spill_pad, n_slot), so a batch
    assembles on the device by stacking: window masks concatenate along
    the tile axis, node fields along the node axis, and the spill lists
    remap from per-graph hop-major rows (k·n + r) to batch hop-major rows
    (k·B·n + b·n + r).  Pad spill entries carry the per-graph sentinel
    row K·n, which remaps to >= K·B·n and keeps dropping.  The last slot
    is the empty pad graph."""

    live: torch.Tensor                    # (Gs, K, T, tile, win) int8 | f32
    counts1: torch.Tensor                 # (Gs, n, V1) f32
    countsk: Optional[torch.Tensor]       # (Gs, n, K-1, Vk) | None
    union_deg: torch.Tensor               # (Gs, n)
    hop_deg: torch.Tensor                 # (Gs, n, K)
    spill_rows: Optional[torch.Tensor]    # (Gs, S) int32, k*n + r
    spill_senders: Optional[torch.Tensor]  # (Gs, S) int32, k*n + s
    spill_weights: Optional[torch.Tensor]  # (Gs, S) f32 | None
    x: Optional[torch.Tensor]
    node_mask: torch.Tensor
    graph_valid: torch.Tensor
    pe_attr: Optional[torch.Tensor]
    peripheral_edge_attr: Optional[torch.Tensor]
    peripheral_config_attr: Optional[torch.Tensor]
    rd: Optional[torch.Tensor]
    z: Optional[torch.Tensor]
    pos: Optional[torch.Tensor]
    y: Optional[torch.Tensor]
    tile: int
    halo: int
    sender_scaled: bool
    y_is_node_level: bool = False

    @property
    def num_graphs(self) -> int:
        return self.live.shape[0] - 1

    @property
    def n_slot(self) -> int:
        return self.node_mask.shape[-1]

    @property
    def n_hops(self) -> int:
        return self.live.shape[1]

    def nbytes(self) -> int:
        return _nbytes(self)


def banded_store_nbytes(graphs: Sequence[Graph], n_slot: int, tile: int,
                        halo: int, spill_pad: int, v1: int, vk: int,
                        y_is_node_level: bool = False,
                        gcn_norm: bool = False) -> int:
    """A BandedStore's device bytes, counted at the stored dtypes: the
    mask at 1 byte an entry, or 4 under ``gcn_norm`` (the JAX estimate
    counts 1 byte either way, and leaves out y and the masks)."""
    K = graphs[0].K
    per = (4 if gcn_norm else 1) * K * n_slot * (tile + 2 * halo)
    per += 4 * n_slot * (v1 + (K - 1) * vk + 1 + K)   # counts + degrees
    per += spill_pad * (8 + (4 if gcn_norm else 0))   # rows, senders, w
    return (len(graphs) + 1) * (per + _field_bytes(graphs, n_slot,
                                                   y_is_node_level))


def plan_banded_store_shapes(graphs: Sequence[Graph]):
    """Shared (tile, halo, n_slot, spill_pad) over a graph set, by the
    auto rules of collate_banded and the loader: the halo sized to the
    worst edge span (capped), tile 128 when the halo fits under it, slots
    rounded up to the tile, and the largest exact per-graph spill at
    that (tile, halo)."""
    cap = min(DEFAULT_HALO_CAP, BANDED_TILE)
    span = max((int(np.abs(g.edge_index[0].astype(np.int64)
                           - g.edge_index[1]).max())
                for g in graphs if g.num_edges), default=0)
    halo = min(-(-span // HALO_ALIGN) * HALO_ALIGN, cap)
    tile = 128 if halo <= 128 else BANDED_TILE
    n_slot = -(-max(g.num_nodes for g in graphs) // tile) * tile
    spill = 0
    for g in graphs:
        if not g.num_edges:
            continue
        r = np.asarray(g.edge_index[1], np.int64)
        s = np.asarray(g.edge_index[0], np.int64)
        t_of = r // tile
        reach = np.maximum.reduce([t_of * tile - s,
                                   s - ((t_of + 1) * tile - 1),
                                   np.zeros_like(s)])
        live = np.asarray(g.edge_attr).reshape(g.num_edges, g.K) > 0
        spill = max(spill, int(live[reach > halo].sum()))
    return tile, halo, n_slot, spill


def build_banded_store(graphs: Sequence[Graph], v1: int, vk: int,
                       y_is_node_level: bool = False,
                       gcn_norm: bool = False,
                       shapes: Optional[tuple] = None,
                       device="cpu") -> BandedStore:
    """The dataset's per-graph banded plans as one BandedStore on
    ``device`` (one copy).  ``shapes`` pins (tile, halo, n_slot,
    spill_pad), so that the train, val and test stores share them (the
    Trainer plans them over every split)."""
    Gs = len(graphs) + 1
    K = graphs[0].K
    tile, halo, n_slot, spill_pad = (shapes if shapes is not None
                                     else plan_banded_store_shapes(graphs))
    T = n_slot // tile
    win = tile + 2 * halo
    live = np.zeros((Gs, K, T, tile, win),
                    np.float32 if gcn_norm else np.int8)
    counts1 = np.zeros((Gs, n_slot, v1), np.float32)
    countsk = (np.zeros((Gs, n_slot, K - 1, vk), np.float32)
               if K > 1 else None)
    union_deg = np.zeros((Gs, n_slot), np.float32)
    hop_deg = np.zeros((Gs, n_slot, K), np.float32)
    sp = spill_pad > 0
    # the pad slot's spill entries keep the sentinel row K*n (dropped)
    spill_rows = (np.full((Gs, spill_pad), K * n_slot, np.int32)
                  if sp else None)
    spill_senders = np.zeros((Gs, spill_pad), np.int32) if sp else None
    spill_weights = (np.zeros((Gs, spill_pad), np.float32)
                     if sp and gcn_norm else None)
    node_mask, graph_valid, stack_nodes = _stack_node_fields(graphs, n_slot)
    for i, g in enumerate(graphs):
        if not g.num_edges:
            continue
        r = np.asarray(g.edge_index[1], np.int64)
        s = np.asarray(g.edge_index[0], np.int64)
        attr = np.asarray(g.edge_attr).reshape(g.num_edges, K)
        sw = gcn_sender_weights(r, attr, n_slot) if gcn_norm else None
        plan = build_banded(r, s, attr, n_slot, v1, vk, tile=tile,
                            halo=halo, spill_pad=spill_pad or None,
                            sender_weights=sw, as_numpy=True)
        live[i] = plan.live
        counts1[i] = plan.counts1
        if countsk is not None:
            countsk[i] = plan.countsk
        union_deg[i] = plan.union_deg
        hop_deg[i] = plan.hop_deg
        if sp and plan.spill_rows is not None:
            spill_rows[i] = plan.spill_rows
            spill_senders[i] = plan.spill_senders
            if spill_weights is not None:
                spill_weights[i] = plan.spill_weights
    t = _tensors(device, live=live, counts1=counts1, countsk=countsk,
                 union_deg=union_deg, hop_deg=hop_deg,
                 spill_rows=spill_rows, spill_senders=spill_senders,
                 spill_weights=spill_weights, node_mask=node_mask,
                 graph_valid=graph_valid,
                 y=_stack_y(graphs, n_slot, y_is_node_level),
                 **{f: stack_nodes(f) for f in NODE_FIELDS})
    return BandedStore(**t, tile=tile, halo=halo, sender_scaled=gcn_norm,
                       y_is_node_level=y_is_node_level)


def gather_banded_batch(store: BandedStore, idx: torch.Tensor
                        ) -> GraphBatch:
    """On-device banded batch assembly: graph b owns node slots
    [b * n_slot, (b + 1) * n_slot) (collate_banded packs nodes
    contiguously instead; every downstream op is mask-aware, so the
    layouts give the same losses).  Window masks stack along the tile
    axis; spill rows remap k·n + r -> k·(B·n) + b·n + r, which
    interleaves graphs in the hop-major row space, so the plan clears
    spill_sorted."""
    B, n, K = idx.shape[0], store.n_slot, store.n_hops
    T, tile, win = store.live.shape[2:]
    live = store.live[idx].transpose(0, 1).reshape(K, B * T, tile, win)
    sp_r = sp_s = sp_w = None
    if store.spill_rows is not None:
        offs = (torch.arange(B, device=idx.device, dtype=torch.int32)
                * n)[:, None]

        def remap(a):
            return ((a // n) * (B * n) + offs + a % n).reshape(-1)
        sp_r = remap(store.spill_rows[idx])
        sp_s = remap(store.spill_senders[idx])
        if store.spill_weights is not None:
            sp_w = store.spill_weights[idx].reshape(-1)
    adj = BandedAdj(
        live=live, counts1=store.counts1[idx].reshape(B * n, -1),
        countsk=(store.countsk[idx].reshape(B * n, K - 1, -1)
                 if store.countsk is not None else None),
        union_deg=store.union_deg[idx].reshape(-1),
        hop_deg=store.hop_deg[idx].reshape(B * n, K),
        spill_senders=sp_s, spill_rows=sp_r, spill_weights=sp_w,
        spill_hop_ends=(), sender_scaled=store.sender_scaled,
        spill_sorted=False, tile=tile, halo=store.halo, n_hops=K)
    return _batch(store, idx, adj)


def gather_any(store, idx: torch.Tensor) -> GraphBatch:
    """Dispatch by store type."""
    if isinstance(store, COOStore):
        return gather_coo_batch(store, idx)
    if isinstance(store, BandedStore):
        return gather_banded_batch(store, idx)
    return gather_batch(store, idx)


def epoch_index_chunks(order: np.ndarray, batch_size: int,
                       pad_idx: int) -> np.ndarray:
    """(steps, B) int32 chunks; the trailing partial batch is padded with
    the empty-graph slot index."""
    n = len(order)
    steps = max((n + batch_size - 1) // batch_size, 1)
    out = np.full((steps * batch_size,), pad_idx, dtype=np.int32)
    out[:n] = order
    return out.reshape(steps, batch_size)


def parallel_epoch_index_chunks(order: np.ndarray, batch_size: int,
                                n_dev: int, pad_idx: int) -> np.ndarray:
    """(steps, n_dev, B) int32 chunks; the trailing partial group padded
    with the empty-graph slot (the resident twin of shard_loader's
    masked-empty fill: every graph is seen, none twice)."""
    flat = epoch_index_chunks(order, batch_size * n_dev, pad_idx)
    return flat.reshape(flat.shape[0], n_dev, batch_size)


def _rows(store, chunks) -> torch.Tensor:
    """The index chunks on the store's device, as one copy."""
    return torch.as_tensor(np.asarray(chunks), dtype=torch.long).to(
        store.graph_valid.device)


def make_resident_train_epoch(model, opt, loss: str = "l1",
                              node_level: bool = False):
    """(store, idx_chunks (S, B), generator) -> (mean train loss, per-step
    losses): one ``train_step`` per index row on the gathered batch, the
    sums kept on the device until the epoch ends (``loop.train_epoch``),
    so the epoch's loss is its loss sum over its count."""
    def epoch(store, idx_chunks, generator=None):
        return train_epoch(model, opt, (gather_any(store, idx) for idx in
                                        _rows(store, idx_chunks)),
                           loss, generator, node_level)
    return epoch


def make_resident_eval(model, loss: str = "l1", node_level: bool = False,
                       metric: str = "same", bn_train_mode: bool = False):
    """(store, idx_chunks (S, B)) -> ``loop.evaluate``'s metrics over the
    gathered batches (``bn_train_mode`` as there)."""
    def run(store, idx_chunks):
        return evaluate(model, (gather_any(store, idx) for idx in
                                _rows(store, idx_chunks)),
                        loss, metric, node_level, bn_train_mode)
    return run


def make_parallel_resident_train_epoch(model, opt, mesh, loss: str = "l1",
                                       node_level: bool = False, axes=None):
    """Data-parallel resident epoch: (store, idx_chunks (S, P, B),
    generator) -> (mean train loss, per-step losses) over the group; each
    step gathers this rank's column (its index along ``axes``) and takes
    ``dp.parallel_train_step``."""
    from ..parallel.dp import make_parallel_train_step

    step = make_parallel_train_step(mesh, axes)
    me = mesh.axis_index(axes)

    def epoch(store, idx_chunks, generator=None):
        return train_epoch(model, opt, (gather_any(store, idx) for idx in
                                        _rows(store, idx_chunks)[:, me]),
                           loss, generator, node_level, step=step)
    return epoch


def make_parallel_resident_eval(model, mesh, loss: str = "l1",
                                node_level: bool = False,
                                metric: str = "same",
                                bn_train_mode: bool = False, axes=None):
    """(store, idx_chunks (S, P, B)) -> the metrics over every rank's
    gathered batches (the sums all-reduced over the group)."""
    from ..parallel.dp import make_parallel_eval_step

    step = make_parallel_eval_step(mesh, axes)
    me = mesh.axis_index(axes)

    def run(store, idx_chunks):
        return evaluate(model, (gather_any(store, idx) for idx in
                                _rows(store, idx_chunks)[:, me]),
                        loss, metric, node_level, bn_train_mode, step=step)
    return run
