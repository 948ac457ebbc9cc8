"""Numpy graph oracles (counterpart of kpgnn_tpu/data/algorithms.py; the
labels of the counting and property datasets).  All take dense
symmetric {0,1} adjacency matrices without self-loops.  The oracles no
ported dataset uses (predecessors, page rank, the simulation labels) are
not ported yet."""
from __future__ import annotations

import math
from collections import deque

import numpy as np


def all_pairs_shortest_paths(A: np.ndarray, inf_sub=math.inf) -> np.ndarray:
    """Floyd–Warshall; unreachable pairs become ``inf_sub``."""
    n = A.shape[0]
    dist = np.where(A > 0, 1.0, np.inf)
    np.fill_diagonal(dist, 0.0)
    for k in range(n):
        dist = np.minimum(dist, dist[:, k:k + 1] + dist[k:k + 1, :])
    if not math.isinf(inf_sub):
        dist = np.where(np.isinf(dist), inf_sub, dist)
    return dist


def is_connected(A: np.ndarray) -> float:
    """1.0 when a BFS from node 0 reaches every node, else 0.0."""
    n = A.shape[0]
    seen = np.zeros(n, dtype=bool)
    q = deque([0])
    seen[0] = True
    while q:
        u = q.popleft()
        for v in np.flatnonzero(A[u]):
            if not seen[v]:
                seen[v] = True
                q.append(int(v))
    return float(seen.all())


def diameter(A: np.ndarray) -> float:
    """Longest finite shortest path."""
    d = all_pairs_shortest_paths(A)
    finite = d[np.isfinite(d)]
    return float(finite.max()) if finite.size else 0.0


def eccentricity(A: np.ndarray) -> np.ndarray:
    """Per-node eccentricity; unreachable pairs map to -1 before the max."""
    d = all_pairs_shortest_paths(A)
    cap = np.sum(A)
    d = np.where(d < cap + 1, d, -1.0)
    return np.max(d, axis=0)


def sssp_dist(A: np.ndarray, source: int) -> np.ndarray:
    """Shortest-path distances from ``source``; unreachable -> 0."""
    return all_pairs_shortest_paths(A, 0)[source]


def graph_laplacian(A: np.ndarray) -> np.ndarray:
    return np.diag(A.sum(axis=0)) - A


def graph_laplacian_features(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    """L @ F."""
    return graph_laplacian(A) @ F


def spectral_radius(A: np.ndarray) -> float:
    return float(np.max(np.abs(np.linalg.eigvals(A)).real))


def _comb(n, k):
    return math.comb(int(n), k) if n >= k else 0


def substructure_counts(A: np.ndarray) -> np.ndarray:
    """[triangle, tailed-triangle, 3-star, 4-cycle, custom] counts in
    closed form from powers of A."""
    A = A.astype(np.float64)
    A2 = A @ A
    A3 = A2 @ A
    deg = A.sum(axis=0)
    tri = np.trace(A3) / 6.0
    tailed = float(((np.diag(A3) / 2.0) * (deg - 2.0)).sum())
    star = float(sum(_comb(d, 3) for d in deg))
    cyc4 = (np.trace(A3 @ A) + np.trace(A2) - 2.0 * A2.sum()) / 8.0
    custom = float((A @ np.diag(np.exp(-A2.sum(axis=1))) @ A).sum())
    return np.array([tri, tailed, star, cyc4, custom], dtype=np.float64)
