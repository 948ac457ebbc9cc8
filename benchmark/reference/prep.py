"""The k-hop preparation of one raw molecule, in plain numpy, written
from the KP-GNN paper's definitions (SPD kernel) and the original code's
value conventions (data_utils.py of the KP-GNN repository), not from the
program: it imports nothing of it.

For a molecule of n atoms it gives, per hop k = 1..K, the directed
edges (sender, receiver) whose shortest-path distance is k, each with
its code: the bond code at hop 1, min(walks of length k, max_pe) + 1 at
hop k >= 2, where walks are counted on the adjacency with its diagonal
cleared after every power; the path encoding of each node (the cleared
diagonal of the same counts, so 0); the peripheral edge-type histogram
and configuration of each node's hop-k ring; and, with ``use_rd``, the
resistance distance of each node to node 0 over the k-hop union.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor
from typing import Dict, List, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class PrepConfig:
    K: int
    max_pe: int
    max_hop: int                # peripheral configuration depth
    max_edge_type: int
    max_edge_count: int
    max_distance_count: int
    use_rd: bool = False


@dataclasses.dataclass
class Prepped:
    n: int
    hops: List[np.ndarray]      # K arrays (3, E_k): sender, receiver, code
    pe: np.ndarray              # (n, K-1) int
    per_edge: np.ndarray        # (n, K, T, 2) int
    per_config: np.ndarray      # (n, K, max_hop + 1) int
    rd: Optional[np.ndarray]    # (n,) float64 or None


def walk_hops(adj: np.ndarray, K: int):
    """(walk counts per hop with the diagonal cleared, the SPD hop of
    every ordered pair (0 = none))."""
    counts, hop_of = [], np.zeros(adj.shape, np.int64)
    power = np.eye(adj.shape[0], dtype=np.int64)
    for k in range(1, K + 1):
        power = power @ adj
        c = power.copy()
        np.fill_diagonal(c, 0)
        counts.append(c)
        new = (c > 0) & (hop_of == 0)
        hop_of[new] = k
    return counts, hop_of


def subgraph_distances(adj: np.ndarray, member: np.ndarray, depth: int
                       ) -> np.ndarray:
    """For each row i of ``member`` (a node set S_i as a boolean mask), the
    BFS distance between nodes of S_i inside the subgraph S_i induces, up
    to ``depth``: (m, n, n), -1 for pairs outside S_i x S_i, 0 on the
    diagonal and for pairs unreachable within ``depth``."""
    m, n = member.shape
    inside = member[:, :, None] & member[:, None, :]
    sub = (adj[None] > 0) & inside
    dist = np.where(inside, 0, -1).astype(np.int64)
    seen = np.broadcast_to(np.eye(n, dtype=bool), (m, n, n)).copy()
    frontier = sub.copy()
    subf = sub.astype(np.float32)
    for h in range(1, depth + 1):
        new = frontier & ~seen & inside
        if not new.any():
            break
        dist[new] = h
        seen |= new
        frontier = np.matmul(new.astype(np.float32), subf) > 0
    return dist


def peripheral(bond: np.ndarray, ring: np.ndarray, cfg: PrepConfig):
    """Peripheral features of one hop: ``ring`` (n, n) marks each node's
    hop-k neighbours.  Edge part (n, T, 2): the T most frequent bond codes
    among the edges inside the ring (code - 2, count clipped), ties to the
    smaller code.  Configuration (n, max_hop + 1): slot d >= 1 counts the
    ordered ring pairs at distance d inside the ring's subgraph; slot 0 is
    the summed bond codes of the edges joining two ring nodes equally far
    from a third ring node, over all such third nodes and distances; all
    clipped.  A ring of fewer than two nodes, or without an inner edge,
    gives zeros."""
    n = bond.shape[0]
    T, D = cfg.max_edge_type, cfg.max_hop
    member = ring > 0
    inside = member[:, :, None] & member[:, None, :]
    inner = np.where(inside, bond[None], 0)                   # (n, n, n)
    n_types = max(T, int(bond.max()) - 1 if bond.size else 0)
    counts = np.stack([(inner == t + 2).sum((1, 2))
                       for t in range(n_types)], axis=1)       # (n, types)
    live = (member.sum(1) >= 2) & ((inner > 0).sum((1, 2)) > 0)
    edge = np.zeros((n, T, 2), np.int64)
    order = np.argsort(-counts, axis=1, kind="stable")[:, :T]
    edge[:, :, 0] = order
    edge[:, :, 1] = np.minimum(np.take_along_axis(counts, order, 1),
                               cfg.max_edge_count)
    dist = subgraph_distances(bond, member, D)                # (n, n, n)
    # at[i, d - 1, j, a]: ring node a lies at distance d from ring node j
    at = dist[:, None] == np.arange(1, D + 1)[None, :, None, None]
    config = np.zeros((n, D + 1), np.int64)
    config[:, 1:] = at.sum((2, 3))
    a = at.astype(np.float32)           # small integer sums: exact in f32
    w = inner.astype(np.float32)[:, None]
    config[:, 0] = np.rint((np.matmul(a, w) * a).sum((1, 2, 3)))
    config = np.minimum(config, cfg.max_distance_count)
    edge[~live] = 0
    config[~live] = 0
    return edge, config


def resistance_to_first(n: int, send: np.ndarray, recv: np.ndarray
                        ) -> np.ndarray:
    """Resistance distance of every node to node 0 over the given
    edges: R(0, i) = L+_00 + L+_ii - 2 L+_0i, with L+ the Laplacian's
    pseudo-inverse in float64."""
    a = np.zeros((n, n))
    a[send, recv] = 1.0
    lap = np.diag(a.sum(1)) - a
    lp = np.linalg.pinv(lap)
    return lp[0, 0] + np.diagonal(lp) - lp[0] - lp[:, 0]


def prep(mol: Dict, cfg: PrepConfig) -> Prepped:
    n = int(mol["num_nodes"])
    s, r = (np.asarray(a, np.int64) for a in mol["edge_index"])
    adj = np.zeros((n, n), np.int64)
    np.add.at(adj, (s, r), 1)
    bond = np.zeros((n, n), np.int64)
    bond[s, r] = np.asarray(mol["edge_attr"], np.int64).reshape(-1)
    counts, hop_of = walk_hops(adj, cfg.K)
    hops, pe = [], np.zeros((n, max(cfg.K - 1, 0)), np.int64)
    edges, configs = [], []
    for k in range(1, cfg.K + 1):
        ring = np.where(hop_of == k, counts[k - 1], 0)
        u, v = np.nonzero(ring)
        if k == 1:
            code = bond[u, v]
        else:
            code = np.minimum(ring[u, v], cfg.max_pe) + 1
            diag = np.diagonal(ring)
            pe[:, k - 2] = np.where(diag > 0,
                                    np.minimum(diag, cfg.max_pe) + 1, 0)
        keep = code > 0
        hops.append(np.stack([u[keep], v[keep], code[keep]]))
        e, c = peripheral(bond, ring, cfg)
        edges.append(e)
        configs.append(c)
    rd = None
    if cfg.use_rd:
        u, v = np.nonzero(hop_of > 0)
        rd = resistance_to_first(n, u, v)
    return Prepped(n=n, hops=hops, pe=pe,
                   per_edge=np.stack(edges, axis=1),
                   per_config=np.stack(configs, axis=1), rd=rd)


def _prep_one(args):
    return prep(*args)


def prep_all(mols: List[Dict], cfg: PrepConfig, workers: int = 0
             ) -> List[Prepped]:
    """``prep`` of every molecule, on a pool of ``workers`` spawned
    processes (default: one per core, at most 8), all ended on return."""
    workers = workers or min(8, os.cpu_count() or 1)
    if workers <= 1 or len(mols) < 2 * workers:
        return [prep(m, cfg) for m in mols]
    with ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        return list(ex.map(_prep_one, [(m, cfg) for m in mols],
                           chunksize=max(1, len(mols) // (4 * workers))))
