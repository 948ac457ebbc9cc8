"""Synthetic graph generators for benchmarks and shape checks
(counterpart of kpgnn_tpu/data/synthetic.py, numpy only).

``synthetic_molecules`` mimics the ZINC-subset size distribution (9-37
heavy atoms, sparse bonds, small vocab) so benchmark batches exercise
the shapes of the real training path without a download;
``synthetic_polymers`` builds large chain-like graphs with short chords
(bounded bandwidth), the large-graph regime.  Each draws from
``np.random.default_rng(seed)`` in the JAX generator's order, so one
seed gives the same arrays in both packages.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..graph.data import Graph
from ..prep.khop import KHopConfig, extract_khop


def _random_connected(n: int, rng) -> np.ndarray:
    """Random connected sparse undirected graph as (2, E) directed pairs:
    a random spanning tree plus a few extra edges (molecule-like
    density)."""
    edges = set()
    perm = rng.permutation(n)
    for i in range(1, n):
        u = int(perm[rng.integers(0, i)])
        v = int(perm[i])
        edges.add((min(u, v), max(u, v)))
    extra = int(rng.integers(0, max(2, n // 4)))
    for _ in range(extra):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u != v:
            edges.add((min(u, v), max(u, v)))
    e = np.array(sorted(edges), dtype=np.int64)
    return np.concatenate([e, e[:, ::-1]], axis=0).T


def synthetic_molecules(
    n_graphs: int,
    cfg: KHopConfig,
    seed: int = 0,
    n_min: int = 9,
    n_max: int = 37,
    num_atom_types: int = 21,
    num_bond_types: int = 3,
    node_level_y: bool = False,
) -> List[Graph]:
    """``n_graphs`` molecule-like graphs, k-hop prepped under ``cfg``;
    bond codes start at 2 (0 and 1 are reserved by the prep)."""
    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = int(rng.integers(n_min, n_max + 1))
        ei = _random_connected(n, rng)
        e = ei.shape[1]
        ea = np.zeros(e, dtype=np.int64)
        half = e // 2
        t = rng.integers(2, num_bond_types + 2, size=half)
        ea[:half] = t
        ea[half:] = t
        x = rng.integers(0, num_atom_types, size=(n, 1)).astype(np.int64)
        y = (rng.normal(size=(n,)).astype(np.float32) if node_level_y
             else np.array([rng.normal()], dtype=np.float32))
        graphs.append(extract_khop(n, ei, ea, cfg, x=x, y=y))
    return graphs


def synthetic_khop_graphs(n_graphs: int, K: int, seed: int = 0, **kw):
    """``synthetic_molecules`` under the SPD prep the benchmarks use."""
    cfg = KHopConfig(K=K, kernel="spd", max_edge_attr_num=50,
                     max_hop_num=4, max_edge_type=3, max_edge_count=20,
                     max_distance_count=30)
    return synthetic_molecules(n_graphs, cfg, seed=seed, **kw)


def synthetic_polymers(
    n_graphs: int,
    n_nodes: int,
    K: int,
    seed: int = 0,
    chord_window: int = 4,
    num_atom_types: int = 21,
    num_bond_types: int = 3,
    max_pe: int = 30,
) -> List[Graph]:
    """Large locally structured sparse graphs (a polymer-chain analog)
    with SPD k-hop union attrs: a chain backbone plus short-range chords,
    so node order keeps the k-hop sender windows narrow.

    The hop structure is exact SPD (scipy.sparse boolean powers: hop k is
    reachable in k steps minus reachable in fewer); hop 1 carries bond
    codes and hops >= 2 synthetic path codes, the value contract of
    ``prep.extract_khop`` without its dense n x n cost at this n."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    graphs = []
    for _ in range(n_graphs):
        n = n_nodes
        src = np.arange(n - 1)
        dst = src + 1                                   # chain backbone
        extra = rng.integers(2, chord_window + 1, size=n // 2)
        cs = rng.integers(0, n - chord_window - 1, size=n // 2)
        u = np.concatenate([src, cs])
        v = np.concatenate([dst, cs + extra])
        und = np.unique(np.stack([np.minimum(u, v), np.maximum(u, v)], 1),
                        axis=0)
        a1 = sp.coo_matrix(
            (np.ones(len(und), bool), (und[:, 0], und[:, 1])),
            shape=(n, n)).tocsr()
        a1 = (a1 + a1.T).astype(bool)
        reach = a1.copy()                # reachable in <= k hops (no diag)
        hops = [a1]
        for _ in range(K - 1):
            nxt = ((reach @ a1) > 0).astype(bool)
            nxt.setdiag(False)
            nxt.eliminate_zeros()
            new = (nxt > reach).astype(bool)            # exactly this hop
            new.eliminate_zeros()
            hops.append(new)
            reach = ((reach + nxt) > 0).astype(bool)
        rows, cols, attr_cols = [], [], []
        for k, hk in enumerate(hops):
            coo = hk.tocoo()
            rows.append(coo.row)
            cols.append(coo.col)
            codes = (rng.integers(2, num_bond_types + 2, size=coo.nnz)
                     if k == 0 else
                     rng.integers(2, max_pe + 2, size=coo.nnz))
            ac = np.zeros((coo.nnz, K), np.int64)
            ac[:, k] = codes
            attr_cols.append(ac)
        ei = np.stack([np.concatenate(cols),             # senders
                       np.concatenate(rows)])            # receivers
        ea = np.concatenate(attr_cols, axis=0)
        x = rng.integers(0, num_atom_types, size=(n, 1)).astype(np.int64)
        y = np.array([rng.normal()], dtype=np.float32)
        graphs.append(Graph(num_nodes=n, edge_index=ei.astype(np.int64),
                            edge_attr=ea, x=x, y=y))
    return graphs
