"""Offline k-hop neighborhood extraction (SPD and GD kernels).

Counterpart of kpgnn_tpu/prep/khop.py.  Graphs of at most
``native.NATIVE_MAX_NODES`` nodes take the C++ path (prep/native.py)
when it builds, as in the JAX package; both paths give the same arrays.
The cached, pooled runner is prep/runner.py.

Re-derivation of the reference preprocessing semantics
(reference: data_utils.py:20-241) as vectorized numpy over dense per-graph
matrices.  The graphs in every supported benchmark are small (N <= a few
thousand), so dense N x N walk-count matrices beat sparse chains and map
directly onto batched device code if ever moved on-device.

Semantics contract reproduced exactly:
  * Walk-count matrices A^k have their diagonals zeroed at every power
    (reference: data_utils.py:123).
  * SPD kernel: hop-k matrix keeps only entries not seen at hops < k
    (reference: data_utils.py:65-74); GD kernel: union of all hops,
    multiplicity allowed (reference: data_utils.py:57-62).
  * Hop-k edge attr = clip(walk_count, max_edge_attr_num) then +1 on
    nonzero entries — 0 means "absent at this hop", 1 is reserved for the
    model-injected self-loop (reference: data_utils.py:85-87).
  * Hop-1 attr column = original edge attr value, 0 if the union edge is
    not a 1-hop edge (reference: data_utils.py:80).
  * pe_attr = diagonal of the processed hop-k matrix
    (reference: data_utils.py:91).
  * Peripheral attrs per node/hop from the induced subgraph on the hop-k
    neighborhood (reference: data_utils.py:165-221).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..graph.data import Graph


@dataclasses.dataclass(frozen=True)
class KHopConfig:
    K: int
    kernel: str = "spd"                 # "spd" | "gd"
    max_edge_attr_num: int = 1          # a.k.a. max_pe_num upstream
    max_hop_num: int = 0                # peripheral config depth; 0 disables
    max_edge_type: int = 0              # peripheral edge types; 0 disables
    max_edge_count: int = 0
    max_distance_count: int = 0
    use_rd: bool = False

    def __post_init__(self):
        if self.kernel not in ("spd", "gd"):
            raise ValueError(f"unknown kernel {self.kernel!r}")
        if self.K < 1:
            raise ValueError("K must be >= 1")

    @property
    def peripheral_enabled(self) -> bool:
        return self.max_hop_num > 0 and self.max_edge_type > 0


def adjacency_powers(adj: np.ndarray, K: int) -> np.ndarray:
    """Walk-count matrices A^1..A^K with zeroed diagonals, stacked (K, N, N).

    int64 throughout — walk counts grow fast; the reference's int32 can
    overflow on dense graphs, int64 is safe for every benchmark size.
    """
    n = adj.shape[0]
    a = adj.astype(np.int64)
    out = np.empty((K, n, n), dtype=np.int64)
    cur = a.copy()
    np.fill_diagonal(cur, 0)
    out[0] = cur
    prev = a  # powers are computed from the *un*-zeroed chain, as upstream
    for k in range(1, K):
        prev = prev @ a
        cur = prev.copy()
        np.fill_diagonal(cur, 0)
        out[k] = cur
    return out


def _spd_mask(powers: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Mask each hop by everything seen at earlier hops.

    Returns (per-hop matrices with SPD masking applied, binarized union).
    """
    K = powers.shape[0]
    masked = powers.copy()
    seen = (powers[0] > 0)
    for k in range(1, K):
        masked[k][seen] = 0
        seen |= masked[k] > 0
    return masked, seen.astype(np.int64)


def _process_hop_attr(mat: np.ndarray, max_edge_attr_num: int) -> np.ndarray:
    """clip to max_edge_attr_num, then shift nonzeros by +1 (1 = self-loop)."""
    out = np.minimum(mat, max_edge_attr_num)
    out = np.where(out > 0, out + 1, 0)
    return out


def bfs_apsp(adj_bool: np.ndarray, max_length: int) -> np.ndarray:
    """All-pairs shortest path lengths up to `max_length` on a directed
    unweighted graph, via boolean matrix powers.

    dist[i, j] = 0 for i == j, for unreachable pairs, and for pairs farther
    than `max_length` — matching the reference's sparse representation
    (reference: data_utils.py:224-241).
    """
    n = adj_bool.shape[0]
    dist = np.zeros((n, n), dtype=np.int32)
    if n == 0 or max_length < 1:
        return dist
    reach = adj_bool.astype(bool)
    seen = np.eye(n, dtype=bool)
    for h in range(1, max_length + 1):
        new = reach & ~seen
        dist[new] = h
        seen |= new
        if h < max_length:
            if not new.any():
                break
            # frontier-only expansion, accumulated in int32: the previous
            # int8 walk-count matmul wrapped negative past 127 walks and
            # silently corrupted distances on dense neighborhoods
            reach = (new.astype(np.int32) @ adj_bool.astype(np.int32)) > 0
    return dist


def _peripheral_for_hop(
    edge_attr_adj: np.ndarray,
    hop_adj: np.ndarray,
    cfg: KHopConfig,
) -> Tuple[np.ndarray, np.ndarray]:
    """Peripheral edge-type histogram and node-configuration feature for one
    hop (reference: data_utils.py:165-221).

    For each node i with hop-neighborhood S:
      * induce edge_attr_adj[S][:, S];
      * edge feature: per attr-value counts over values >= 2, top
        `max_edge_type` (value - 2, count) pairs by count, counts clipped;
      * configuration: histogram of BFS distances (<= max_hop_num) inside
        the subgraph, slot 0 replaced by the total *weight* of edges between
        equidistant node pairs, all clipped at max_distance_count.
    """
    n = edge_attr_adj.shape[0]
    T, H = cfg.max_edge_type, cfg.max_hop_num
    edge_mat = np.zeros((n, T, 2), dtype=np.int64)
    config_mat = np.zeros((n, H + 1), dtype=np.int64)
    for i in range(n):
        nbr = np.flatnonzero(hop_adj[i] > 0)
        if nbr.size < 2:
            continue
        sub = edge_attr_adj[np.ix_(nbr, nbr)]
        vals = sub[sub > 0]
        if vals.size == 0:
            continue
        counts = np.bincount(vals, minlength=T + 2)[2:]
        # stable descending sort: ties resolve to the smaller type index
        order = np.argsort(-counts, kind="stable")[:T]
        edge_mat[i, :, 0] = order
        edge_mat[i, :, 1] = np.minimum(counts[order], cfg.max_edge_count)

        dist = bfs_apsp(sub > 0, H)
        cfg_feat = np.bincount(dist.ravel(), minlength=H + 1)[: H + 1].astype(np.int64)
        # slot 0 <- total weight of edges connecting nodes equidistant from
        # a common anchor (summed over anchors and distances)
        equi_edges = 0
        m = nbr.size
        for j in range(m):
            dj = dist[j]
            for h in range(1, H + 1):
                idx = np.flatnonzero(dj == h)
                if idx.size >= 2:
                    equi_edges += int(sub[np.ix_(idx, idx)].sum())
        cfg_feat[0] = equi_edges
        config_mat[i] = np.minimum(cfg_feat, cfg.max_distance_count)
    return edge_mat, config_mat


def extract_khop(
    num_nodes: int,
    edge_index: np.ndarray,
    edge_attr: Optional[np.ndarray],
    cfg: KHopConfig,
    x: Optional[np.ndarray] = None,
    y: Optional[np.ndarray] = None,
    **extra,
) -> Graph:
    """Build the K-hop union edge set and all derived attributes for one graph.

    `edge_attr`, if given, must be scalar per edge with values >= 2 (the
    dataset builder applies the +offset so 0/1 stay reserved); if None, all
    1-hop edges get value 2 (reference: data_utils.py:46-50).
    """
    K = cfg.K
    edge_index = np.asarray(edge_index, dtype=np.int64).reshape(2, -1)
    E0 = edge_index.shape[1]

    if E0 == 0:
        pe = np.zeros((num_nodes, K - 1), dtype=np.int32) if K > 1 else None
        per_e = per_c = None
        if cfg.peripheral_enabled:
            per_e = np.zeros((num_nodes, K, cfg.max_edge_type, 2), dtype=np.int32)
            per_c = np.zeros((num_nodes, K, cfg.max_hop_num + 1), dtype=np.int32)
        return Graph(
            num_nodes=num_nodes,
            edge_index=np.zeros((2, 0), dtype=np.int32),
            edge_attr=np.zeros((0, K), dtype=np.int32),
            x=x, y=y, pe_attr=pe,
            peripheral_edge_attr=per_e, peripheral_config_attr=per_c,
            rd=resistance_distance(num_nodes, edge_index) if cfg.use_rd else None,
            **extra,
        )

    if edge_attr is None:
        edge_attr = np.full((E0,), 2, dtype=np.int64)
    else:
        edge_attr = np.asarray(edge_attr, dtype=np.int64).reshape(-1)

    adj = np.zeros((num_nodes, num_nodes), dtype=np.int64)
    np.add.at(adj, (edge_index[0], edge_index[1]), 1)
    edge_attr_adj = np.zeros((num_nodes, num_nodes), dtype=np.int64)
    # duplicate edges: last write wins (matches sparse-matrix sum upstream
    # only when inputs are duplicate-free, which all benchmark data is)
    edge_attr_adj[edge_index[0], edge_index[1]] = edge_attr

    from . import native
    use_native = native.available() and num_nodes <= native.NATIVE_MAX_NODES
    if use_native:
        powers = native.adjacency_powers(adj, K)
        if cfg.kernel == "gd":
            hop_mats, union = powers, native.gd_union(powers)
        else:
            hop_mats, union = native.spd_mask(powers)
    else:
        powers = adjacency_powers(adj, K)
        if cfg.kernel == "gd":
            hop_mats = powers
            union = (powers.sum(axis=0) > 0).astype(np.int64)
        else:
            hop_mats, union = _spd_mask(powers)

    u, v = np.nonzero(union)          # row-major == upstream edge iteration
    E = u.shape[0]

    attr_cols = [edge_attr_adj[u, v]]
    pe_cols = []
    for k in range(1, K):
        proc = _process_hop_attr(hop_mats[k], cfg.max_edge_attr_num)
        attr_cols.append(proc[u, v])
        pe_cols.append(np.diagonal(proc))
    new_edge_attr = np.stack(attr_cols, axis=1).astype(np.int32)     # (E, K)
    pe_attr = (
        np.stack(pe_cols, axis=1).astype(np.int32) if K > 1 else None
    )                                                                 # (N, K-1)

    per_e = per_c = None
    if cfg.peripheral_enabled:
        pe_list, pc_list = [], []
        for k in range(K):
            if use_native:
                em, cm = native.peripheral_hop(
                    edge_attr_adj, hop_mats[k], cfg.max_hop_num,
                    cfg.max_edge_type, cfg.max_edge_count,
                    cfg.max_distance_count)
            else:
                em, cm = _peripheral_for_hop(edge_attr_adj, hop_mats[k], cfg)
            pe_list.append(em)
            pc_list.append(cm)
        per_e = np.stack(pe_list, axis=1).astype(np.int32)   # (N, K, T, 2)
        per_c = np.stack(pc_list, axis=1).astype(np.int32)   # (N, K, H+1)

    union_ei = np.stack([u, v]).astype(np.int32)
    return Graph(
        num_nodes=num_nodes,
        edge_index=union_ei,
        edge_attr=new_edge_attr,
        x=x, y=y, pe_attr=pe_attr,
        peripheral_edge_attr=per_e, peripheral_config_attr=per_c,
        # rd is computed on the K-hop UNION edge set, not the raw graph:
        # the reference applies resistance_distance AFTER
        # extract_multi_hop_neighbors in its pre_transform Compose
        # (reference: train_qm9.py:241, data_utils.py:280-303)
        rd=resistance_distance(num_nodes, union_ei) if cfg.use_rd else None,
        **extra,
    )


def resistance_distance(num_nodes: int, edge_index: np.ndarray) -> np.ndarray:
    """Resistance distance of every node to node 0 via the Laplacian
    pseudo-inverse (reference: data_utils.py:280-303), as an (N, 1) float32
    node feature."""
    A = np.zeros((num_nodes, num_nodes), dtype=np.float64)
    if edge_index.size:
        A[edge_index[0], edge_index[1]] = 1.0
    deg = A.sum(axis=1)
    L = np.diag(deg) - A
    L_inv = np.linalg.pinv(L)
    diag = np.diagonal(L_inv)
    rd = diag[0] + diag - L_inv[0, :] - L_inv[:, 0]
    return rd.astype(np.float32).reshape(-1, 1)


def apply_ablation_clamps(
    g: Graph, wo_path_encoding: bool = False, wo_edge_feature: bool = False
) -> Graph:
    """Runtime ablation clamps (reference: data_utils.py:306-347).

    wo_path_encoding: hop-k attrs clamp to <= 2 and pe_attr zeroes out;
    wo_edge_feature: the 1-hop type column clamps to <= 2.
    """
    if not (wo_path_encoding or wo_edge_feature):
        return g
    ea = g.edge_attr.copy()
    pe = g.pe_attr
    if wo_edge_feature and ea.size:
        ea[:, 0] = np.minimum(ea[:, 0], 2)
    if wo_path_encoding:
        if ea.size and ea.shape[1] > 1:
            ea[:, 1:] = np.minimum(ea[:, 1:], 2)
        if pe is not None:
            pe = np.zeros_like(pe)
    return g.replace(edge_attr=ea, pe_attr=pe)


def extract_graphs(raw_graphs, cfg: KHopConfig) -> List[Graph]:
    """``extract_khop`` over a list of raw graph dicts (num_nodes,
    edge_index and optional edge_attr / x / y / z / pos), serially and
    without a cache (``runner.preprocess_graphs`` adds both)."""
    return [extract_khop(num_nodes=raw["num_nodes"],
                         edge_index=raw["edge_index"],
                         edge_attr=raw.get("edge_attr"), cfg=cfg,
                         x=raw.get("x"), y=raw.get("y"), z=raw.get("z"),
                         pos=raw.get("pos"))
            for raw in raw_graphs]
