"""Numpy graph oracles (counterpart of kpgnn_tpu/data/algorithms.py): the
labels of the counting and property datasets, and the reference's
remaining oracles (reference: datasets/graph_algorithms.py), for test
oracles and label generation.  All take dense symmetric {0,1} adjacency
matrices without self-loops.

Three of the remaining oracles keep the JAX package's values where they
part from the reference's (ADVICE.md): ``min_neighbourhood``,
``std_neighbourhood`` and ``local_maxima`` leave the node itself out of
its neighbourhood and ``local_maxima`` takes a strict maximum;
``is_eulerian_cyclable`` / ``is_eulerian_percorrible`` test
connectivity over the non-isolated nodes only; ``tsp_length`` is the
closed tour through node 0 over every node, not the reference's open
path over the F-selected nodes."""
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


def max_eigenvalue(A: np.ndarray) -> float:
    return float(np.max(np.linalg.eigvalsh(A)))


def page_rank(A: np.ndarray, d: float = 0.85, iters: int = 64) -> np.ndarray:
    n = A.shape[0]
    deg = np.maximum(A.sum(axis=1), 1.0)
    M = (A / deg[:, None]).T
    r = np.full(n, 1.0 / n)
    for _ in range(iters):
        r = (1 - d) / n + d * (M @ r)
    return r


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


def sssp_predecessor(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    """BFS predecessor matrix from the one-hot source in F
    (reference: graph_algorithms.py:338-360)."""
    s = int(np.argmax(F))
    n = A.shape[0]
    P = np.zeros_like(A)
    seen = np.zeros(n, dtype=bool)
    seen[s] = True
    q = deque([s])
    while q:
        u = q.popleft()
        for v in np.flatnonzero(A[u]):
            if not seen[v]:
                seen[v] = True
                P[v, u] = 1.0
                q.append(int(v))
    return P


def count_edges(A: np.ndarray) -> float:
    return float(A.sum() / 2.0)


def first_neighbours(A: np.ndarray) -> np.ndarray:
    return A.sum(axis=0)


def kth_neighbours(A: np.ndarray, k: int) -> np.ndarray:
    """Per node: count of nodes reachable in <= k hops, excluding self
    (reference: graph_algorithms.py:49-62 — despite the docstring there,
    the code counts the <= k reachable set, not the k-th ring)."""
    d = all_pairs_shortest_paths(A, math.inf)
    return ((d <= k) & (d > 0)).sum(axis=0).astype(np.float64)


def mean_neighbourhood(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    deg = np.maximum(A.sum(axis=1), 1.0)
    return (A @ F) / deg


def max_neighbourhood(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    out = np.full(A.shape[0], -np.inf)
    for i in range(A.shape[0]):
        nbr = np.flatnonzero(A[i])
        out[i] = F[nbr].max() if nbr.size else F[i]
    return out


def max_eigenvalues(A: np.ndarray, k: int) -> np.ndarray:
    ev = np.sort(np.linalg.eigvalsh(A))[::-1]
    return ev[:k]


def wl_colors(A: np.ndarray, labels=None, iters: int = 10) -> tuple:
    """1-WL color refinement; returns the sorted color histogram signature
    (two graphs with different signatures are non-isomorphic)."""
    n = A.shape[0]
    colors = (np.zeros(n, dtype=np.int64) if labels is None
              else np.asarray(labels, dtype=np.int64).copy())
    for _ in range(iters):
        sigs = []
        for i in range(n):
            nbr = tuple(sorted(colors[np.flatnonzero(A[i])].tolist()))
            sigs.append((int(colors[i]), nbr))
        uniq = {s: c for c, s in enumerate(sorted(set(sigs)))}
        new = np.array([uniq[s] for s in sigs], dtype=np.int64)
        if len(set(new.tolist())) == len(set(colors.tolist())):
            colors = new
            break
        colors = new
    vals, cnts = np.unique(colors, return_counts=True)
    return tuple(sorted(cnts.tolist()))


# ---------------------------------------------------------------------------
# The reference's remaining (dataset-unused) oracles, for drop-in parity
# (reference: datasets/graph_algorithms.py:19-62,83-127,191-290,384-510).
# Independent implementations; present so a user porting label-generation
# code finds the full surface.
# ---------------------------------------------------------------------------

def identity(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    return np.asarray(F).copy()


def second_neighbours(A: np.ndarray) -> np.ndarray:
    """Per node: count of nodes reachable in <= 2 hops, excluding self
    (reference: graph_algorithms.py:37-47)."""
    return kth_neighbours(A, 2)


def map_reduce_neighbourhood(A, F, f_reduce, f_map=None, hops: int = 1,
                             consider_itself: bool = False):
    """Per node: reduce f_map(F) over its <= hops neighborhood."""
    F = np.asarray(F)
    vals = f_map(F) if f_map is not None else F
    reach = np.eye(A.shape[0])
    hop = np.eye(A.shape[0])
    for _ in range(hops):
        hop = hop @ A
        reach = reach + hop
    reach = reach > 0
    if not consider_itself:
        np.fill_diagonal(reach, False)
    out = np.empty(A.shape[0], dtype=float)
    for i in range(A.shape[0]):
        nbr = np.flatnonzero(reach[i])
        out[i] = f_reduce(vals[nbr]) if nbr.size else vals[i]
    return out


def min_neighbourhood(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    return map_reduce_neighbourhood(A, F, np.min)


def std_neighbourhood(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    return map_reduce_neighbourhood(A, F, np.std)


def local_maxima(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    """1 where F[i] strictly exceeds every neighbour's value."""
    mx = map_reduce_neighbourhood(A, F, np.max)
    return (np.asarray(F) > mx).astype(float)


def map_reduce_graph(A: np.ndarray, F: np.ndarray, f_reduce) -> float:
    return float(f_reduce(np.asarray(F)))


def mean_graph(A, F):
    return map_reduce_graph(A, F, np.mean)


def max_graph(A, F):
    return map_reduce_graph(A, F, np.max)


def min_graph(A, F):
    return map_reduce_graph(A, F, np.min)


def std_graph(A, F):
    return map_reduce_graph(A, F, np.std)


def is_eulerian_cyclable(A: np.ndarray) -> float:
    """Connected (over non-isolated nodes) with all degrees even."""
    deg = A.sum(axis=1)
    live = deg > 0
    if not live.any():
        return 0.0
    sub = A[np.ix_(live, live)]
    return float(is_connected(sub) and not (deg[live] % 2).any())


def is_eulerian_percorrible(A: np.ndarray) -> float:
    """Eulerian path: connected with exactly 0 or 2 odd-degree nodes."""
    deg = A.sum(axis=1)
    live = deg > 0
    if not live.any():
        return 0.0
    sub = A[np.ix_(live, live)]
    odd = int((deg[live] % 2).sum())
    return float(is_connected(sub) and odd in (0, 2))


def has_hamiltonian_cycle(A: np.ndarray) -> float:
    """Held–Karp bitmask DP over subsets (exact, n <= ~20)."""
    n = A.shape[0]
    if n == 0:
        return 0.0
    if n == 1:
        return 1.0
    full = (1 << n) - 1
    # dp[mask][v]: a path over `mask` starting at node 0 ending at v
    dp = [[False] * n for _ in range(1 << n)]
    dp[1][0] = True
    for mask in range(1 << n):
        if not (mask & 1):
            continue
        for v in range(n):
            if not dp[mask][v]:
                continue
            for w in range(1, n):
                if A[v, w] and not (mask >> w) & 1:
                    dp[mask | (1 << w)][w] = True
    return float(any(dp[full][v] and A[v, 0] for v in range(1, n)))


def max_absolute_eigenvalues(A: np.ndarray, k: int) -> np.ndarray:
    ev = np.linalg.eigvalsh(A)
    return np.sort(np.abs(ev))[::-1][:k]


def max_absolute_eigenvalues_laplacian(A: np.ndarray, n: int) -> np.ndarray:
    return max_absolute_eigenvalues(graph_laplacian(A), n)


def max_eigenvector(A: np.ndarray) -> np.ndarray:
    w, v = np.linalg.eigh(A)
    vec = v[:, np.argmax(w)]
    return vec if vec.sum() >= 0 else -vec


def tsp_length(A: np.ndarray, F=None) -> float:
    """Shortest closed tour visiting every node (Held–Karp over the
    APSP metric closure, so it is defined on any connected graph)."""
    n = A.shape[0]
    if n <= 1:
        return 0.0
    D = all_pairs_shortest_paths(A)
    if not np.isfinite(D).all():
        return math.inf
    full = (1 << n) - 1
    INF = math.inf
    dp = np.full((1 << n, n), INF)
    dp[1][0] = 0.0
    for mask in range(1 << n):
        if not (mask & 1):
            continue
        for v in range(n):
            if dp[mask][v] == INF:
                continue
            for w in range(1, n):
                if not (mask >> w) & 1:
                    nm = mask | (1 << w)
                    cand = dp[mask][v] + D[v, w]
                    if cand < dp[nm][w]:
                        dp[nm][w] = cand
    return float(min(dp[full][v] + D[v, 0] for v in range(1, n)))


def isomorphism(A1: np.ndarray, A2: np.ndarray, F1=None, F2=None) -> bool:
    """Backtracking exact isomorphism with WL-signature pruning (the
    reference's checker is WL-based and can report false positives on
    WL-equivalent pairs; exact search avoids that for test-oracle use)."""
    n = A1.shape[0]
    if A2.shape[0] != n:
        return False
    if wl_colors(A1, F1)[0] != wl_colors(A2, F2)[0]:
        return False
    deg1 = A1.sum(1)
    deg2 = A2.sum(1)
    order = np.argsort(-deg1)
    used = [False] * n
    mapping = [-1] * n

    def ok(i, cand):
        u = order[i]
        if deg1[u] != deg2[cand]:
            return False
        if F1 is not None and F2 is not None and F1[u] != F2[cand]:
            return False
        for j in range(i):
            if A1[u, order[j]] != A2[cand, mapping[j]]:
                return False
        return True

    def rec(i):
        if i == n:
            return True
        for cand in range(n):
            if not used[cand] and ok(i, cand):
                used[cand] = True
                mapping[i] = cand
                if rec(i + 1):
                    return True
                used[cand] = False
                mapping[i] = -1
        return False

    return rec(0)


def get_nodes_labels(A: np.ndarray, F: np.ndarray) -> np.ndarray:
    """The reference's node-label bundle (N, 7): [identity, mean/max/std
    of the closed 1-hop neighbourhood, first/second neighbour counts,
    eccentricity] (reference: datasets/graph_algorithms.py:495-507)."""
    F = np.asarray(F, float)
    cols = [identity(A, F),
            map_reduce_neighbourhood(A, F, np.mean, consider_itself=True),
            map_reduce_neighbourhood(A, F, np.max, consider_itself=True),
            map_reduce_neighbourhood(A, F, np.std, consider_itself=True),
            first_neighbours(A).astype(float),
            second_neighbours(A).astype(float),
            eccentricity(A).astype(float)]
    return np.stack(cols, axis=1)


def get_graph_labels(A: np.ndarray, F=None) -> np.ndarray:
    """The reference's graph-label bundle: [diameter]
    (reference: datasets/graph_algorithms.py:510-519)."""
    return np.asarray([diameter(A)], dtype=float)
