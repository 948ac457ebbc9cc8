"""Batch iterator: Graph list -> stream of padded GraphBatches
(counterpart of kpgnn_tpu/train/loader.py, modes "coo", "pallas",
"dense" and "banded").

Pad sizes are chosen once per loader (worst case over the dataset; in
dense mode the node slot of the largest graph), as in the JAX loader, so
one list of graphs gives the same node layout in both packages.
Shuffled iteration collates on a background thread; ordered (eval)
iteration collates once and replays.  Batches are CPU tensors; the
trainer moves them to its device.
"""
from __future__ import annotations

import math
import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from ..graph.batch import (BucketSpec, GraphBatch, collate, collate_banded,
                           collate_dense, collate_pallas)
from ..graph.data import Graph
from ..ops.banded import BANDED_TILE, DEFAULT_HALO_CAP, HALO_ALIGN
from ..utils.profiling import span


def background_iter(factory, maxsize: int = 2):
    """Run ``factory()`` (an iterator) on a daemon thread and yield its
    items through a bounded queue.  Abandoning the generator cancels the
    producer: its puts are timed and observe a cancel event.  Each wait
    for the queue is a ``loop.wait`` span on the consuming thread."""
    q: "queue.Queue" = queue.Queue(maxsize=maxsize)
    SENTINEL = object()
    cancel = threading.Event()

    def put(item) -> bool:
        while not cancel.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                pass
        return False

    def producer():
        try:
            for item in factory():
                if not put(item):
                    return
            put(SENTINEL)
        except BaseException as e:      # surfaced in the consumer
            put(e)

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    try:
        while True:
            with span("loop.wait"):
                item = q.get()
            if item is SENTINEL:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
        t.join()
    finally:
        cancel.set()


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class GraphLoader:
    """mode="coo" (the default, as in the JAX loader): batches carry the
    receiver-sorted edge list; mode="pallas": the fused-hop kernel plan;
    mode="dense": per-graph hop-attr tiles of ``n_slot`` nodes (default:
    the largest graph, rounded up to 8) and ``batch_size`` graph slots;
    mode="banded": the halo-window plan (``banded_gcn_norm`` folds
    KPGCN's sender scale into it), its halo and spill length pinned to
    the dataset's worst case (``banded_halo``, ``banded_spill_pad``) so
    that every batch has one shape.  Pallas, dense and banded need v1/vk
    equal to the model's num_hop1_edge + 2 / max_pe_num + 2.
    ``drop_last`` leaves out the last batch when it is not full, as the
    Trainer's resident epochs then do.

    JAX-only: ``pallas_geometry`` (the TPU kernel's tile_r, wblock and
    egroup) is not accepted; the Hopper kernel's plan has no tiles."""

    def __init__(
        self,
        graphs: Sequence[Graph],
        batch_size: int,
        shuffle: bool = False,
        seed: int = 0,
        n_pad: Optional[int] = None,
        e_pad: Optional[int] = None,
        spec: Optional[BucketSpec] = None,
        y_is_node_level: bool = False,
        drop_last: bool = False,
        mode: str = "coo",
        v1: Optional[int] = None,
        vk: Optional[int] = None,
        n_slot: Optional[int] = None,
        banded_gcn_norm: bool = False,
    ):
        if mode not in ("coo", "pallas", "dense", "banded"):
            raise NotImplementedError(
                f"no loader mode {mode!r}: the mode must be 'coo', "
                "'pallas', 'dense' or 'banded'")
        if mode != "coo" and (v1 is None or vk is None):
            raise ValueError(f"{mode} mode needs v1/vk vocab sizes")
        self.graphs = list(graphs)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.y_is_node_level = y_is_node_level
        self.drop_last = drop_last
        self.mode = mode
        self.v1, self.vk = v1, vk
        self.banded_gcn_norm = banded_gcn_norm
        spec = spec or BucketSpec()
        if mode == "banded":
            self._pin_banded_shapes()
        if mode == "dense":
            max_n = max(g.num_nodes for g in self.graphs)
            self.n_slot = (n_slot if n_slot is not None
                           else _round_up(max_n, 8))
            if max_n > self.n_slot:
                raise ValueError(f"n_slot {self.n_slot} < largest graph "
                                 f"{max_n}")
            self.g_pad = batch_size         # no reserved pad graph slot
            return
        if n_pad is None or e_pad is None:
            # worst case: batch_size largest graphs end up together
            ns = sorted((g.num_nodes for g in self.graphs), reverse=True)
            es = sorted((g.num_edges for g in self.graphs), reverse=True)
            dn, de = spec.pad_sizes(sum(ns[:batch_size]),
                                    sum(es[:batch_size]))
            n_pad = n_pad if n_pad is not None else dn
            e_pad = e_pad if e_pad is not None else de
        self.n_pad, self.e_pad = n_pad, e_pad
        self.g_pad = batch_size + 1

    def _pin_banded_shapes(self) -> None:
        """The dataset's worst-case halo (its largest edge span, capped)
        and spill length (the batch_size graphs with the most live hop
        entries beyond that halo), as the JAX loader pins them."""
        cap = min(DEFAULT_HALO_CAP, BANDED_TILE)
        spans_max, spills = [], []
        for g in self.graphs:
            span = np.abs(g.edge_index[0].astype(np.int64)
                          - g.edge_index[1]).astype(np.int64)
            spans_max.append(int(span.max()) if len(span) else 0)
            spills.append((span, np.asarray(g.edge_attr) > 0))
        need = min(max(spans_max, default=0), cap)
        self.banded_halo = -(-need // HALO_ALIGN) * HALO_ALIGN
        # an edge with span <= halo never spills (reach <= span)
        per_g = sorted((int(live[span > self.banded_halo].sum())
                        for span, live in spills), reverse=True)
        self.banded_spill_pad = sum(per_g[:self.batch_size]) or None

    def example(self) -> GraphBatch:
        return self._collate(self.graphs[: self.batch_size])

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.graphs) // self.batch_size
        return math.ceil(len(self.graphs) / self.batch_size)

    def _collate(self, batch_graphs) -> GraphBatch:
        with span("loader.collate"):
            if self.mode == "dense":
                return collate_dense(batch_graphs, n_slot=self.n_slot,
                                     v1=self.v1, vk=self.vk,
                                     g_pad=self.g_pad,
                                     y_is_node_level=self.y_is_node_level)
            if self.mode == "coo":
                return collate(batch_graphs, n_pad=self.n_pad,
                               e_pad=self.e_pad, g_pad=self.g_pad,
                               y_is_node_level=self.y_is_node_level)
            if self.mode == "banded":
                return collate_banded(
                    batch_graphs, v1=self.v1, vk=self.vk, n_pad=self.n_pad,
                    e_pad=self.e_pad, g_pad=self.g_pad,
                    y_is_node_level=self.y_is_node_level,
                    halo=self.banded_halo, spill_pad=self.banded_spill_pad,
                    gcn_norm=self.banded_gcn_norm)
            return collate_pallas(
                batch_graphs, v1=self.v1, vk=self.vk, n_pad=self.n_pad,
                e_pad=self.e_pad, g_pad=self.g_pad,
                y_is_node_level=self.y_is_node_level)

    def __iter__(self) -> Iterator[GraphBatch]:
        bs = self.batch_size
        if not self.shuffle:
            if not hasattr(self, "_cache"):
                self._cache = [self._collate(self.graphs[i * bs:(i + 1) * bs])
                               for i in range(len(self))]
            yield from self._cache
            return
        order = np.arange(len(self.graphs))
        self.rng.shuffle(order)
        n_batches = len(self)

        def batches():
            for i in range(n_batches):
                idx = order[i * bs:(i + 1) * bs]
                yield self._collate([self.graphs[j] for j in idx])

        yield from background_iter(batches, maxsize=2)
