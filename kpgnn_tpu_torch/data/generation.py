"""Random graph families (counterpart of kpgnn_tpu/data/generation.py),
without networkx.

Ten families plus the PNA-style mixture; graphs are undirected, simple,
without self-loops, returned as dense {0,1} adjacency matrices with node
values drawn U[0,1].  The JAX package builds the families with networkx;
here each is a copy of the networkx 3.6.1 algorithm it calls (networkx is
BSD-3-Clause, (c) the NetworkX Developers), reduced to an edge list.  An
int seed gives networkx's ``@py_random_state`` a ``random.Random(seed)``;
the copies draw from the same stdlib generator in the same order, and
label nodes in networkx's insertion order, so a seed gives the JAX
package's adjacency.
"""
from __future__ import annotations

import math
import random
from collections import Counter
from enum import Enum
from itertools import chain, combinations
from typing import List, Optional, Tuple

import numpy as np

Edges = List[Tuple[int, int]]


class GraphType(Enum):
    RANDOM = 0
    ERDOS_RENYI = 1
    BARABASI_ALBERT = 2
    GRID = 3
    CAVEMAN = 5
    TREE = 6
    LADDER = 7
    LINE = 8
    STAR = 9
    CATERPILLAR = 10
    LOBSTER = 11


MIXTURE = [
    (GraphType.ERDOS_RENYI, 0.2), (GraphType.BARABASI_ALBERT, 0.2),
    (GraphType.GRID, 0.05), (GraphType.CAVEMAN, 0.05), (GraphType.TREE, 0.15),
    (GraphType.LADDER, 0.05), (GraphType.LINE, 0.05), (GraphType.STAR, 0.05),
    (GraphType.CATERPILLAR, 0.1), (GraphType.LOBSTER, 0.1),
]


# tries of the power-law tree's degree sequence before the Prüfer fallback
TREE_TRIES = 10000


class TreeSequenceError(RuntimeError):
    """No tree degree sequence within the tries (networkx raises
    NetworkXError there)."""


def _largest_divisor_leq_sqrt(N: int) -> int:
    m = 1
    for i in range(1, int(math.sqrt(N)) + 1):
        if N % i == 0:
            m = i
    return m


# ---- copies of networkx 3.6.1's generators, as edge lists ----

def _pairwise(nodes) -> Edges:
    nodes = list(nodes)
    return list(zip(nodes, nodes[1:]))


def fast_gnp_random_graph(n: int, p: float, rng: random.Random) -> Edges:
    """networkx.fast_gnp_random_graph (undirected); p outside (0, 1)
    takes gnp_random_graph's draw-free branches."""
    if p >= 1:
        return list(combinations(range(n), 2))
    if p <= 0:
        return []
    edges = []
    lp = math.log(1.0 - p)
    v, w = 1, -1
    while v < n:
        lr = math.log(1.0 - rng.random())
        w = w + 1 + int(lr / lp)
        while w >= v and v < n:
            w = w - v
            v = v + 1
        if v < n:
            edges.append((v, w))
    return edges


def barabasi_albert_graph(n: int, m: int, rng: random.Random) -> Edges:
    """networkx.barabasi_albert_graph from its default star seed graph on
    m + 1 nodes; ``_random_subset`` is the same set of draws."""
    if m < 1 or m >= n:
        raise ValueError(f"Barabási–Albert network must have m >= 1 and "
                         f"m < n, m = {m}, n = {n}")
    edges = [(0, i) for i in range(1, m + 1)]
    # every node repeated once per edge, in the star's node order
    repeated = [0] * m + list(range(1, m + 1))
    source = m + 1
    while source < n:
        targets = set()
        while len(targets) < m:
            targets.add(rng.choice(repeated))
        edges.extend(zip([source] * m, targets))
        repeated.extend(targets)
        repeated.extend([source] * m)
        source += 1
    return edges


def _is_valid_tree_degree_sequence(seq) -> bool:
    """networkx.utils.is_valid_tree_degree_sequence."""
    if 2 * len(seq) - sum(seq) != 2:
        return False
    return seq == [0] or all(d > 0 for d in seq)


def degree_sequence_tree(seq) -> Edges:
    """networkx.degree_sequence_tree on a valid tree degree sequence of
    two or more nodes: a path backbone over the degrees above 1, then the
    leaves."""
    deg = sorted((s for s in seq if s > 1), reverse=True)
    n = len(deg) + 2
    edges = _pairwise(range(n))
    last = n
    for source in range(1, n - 1):
        nedges = deg.pop() - 2
        edges.extend((source, t) for t in range(last, last + nedges))
        last += nedges
    return edges


def random_powerlaw_tree(n: int, rng: random.Random, gamma: int = 3,
                         tries: int = 100) -> Edges:
    """networkx.random_powerlaw_tree through
    random_powerlaw_tree_sequence; raises TreeSequenceError where
    networkx raises NetworkXError."""
    z = [rng.paretovariate(gamma - 1) for _ in range(n)]
    zseq = [min(n, max(round(s), 0)) for s in z]
    z = [rng.paretovariate(gamma - 1) for _ in range(tries)]
    swap = [min(n, max(round(s), 0)) for s in z]
    for _ in swap:          # as networkx: pops shorten the loop
        if _is_valid_tree_degree_sequence(zseq):
            return degree_sequence_tree(zseq)
        index = rng.randint(0, n - 1)
        zseq[index] = swap.pop()
    raise TreeSequenceError(
        f"Exceeded max ({tries}) attempts for a valid tree sequence.")


def from_prufer_sequence(sequence) -> Edges:
    """networkx.from_prufer_sequence (Wang, Wang and Wu's O(n) decoder) on
    a valid sequence (values in 0 .. len + 1)."""
    n = len(sequence) + 2
    degree = Counter(chain(sequence, range(n)))
    edges = []
    not_orphaned = set()
    index = u = next(k for k in range(n) if degree[k] == 1)
    for v in sequence:
        edges.append((u, v))
        not_orphaned.add(u)
        degree[v] -= 1
        if v < index and degree[v] == 1:
            u = v
        else:
            index = u = next(k for k in range(index + 1, n)
                             if degree[k] == 1)
    u, v = set(range(n)) - not_orphaned
    edges.append((u, v))
    return edges


def random_labeled_tree(n: int, rng: random.Random) -> Edges:
    """networkx.random_labeled_tree: a uniform Prüfer sequence."""
    if n == 1:
        return []
    return from_prufer_sequence([rng.choice(range(n)) for _ in range(n - 2)])


def grid_2d_graph(m: int, n: int) -> Edges:
    """networkx.grid_2d_graph relabelled by
    convert_node_labels_to_integers: node (i, j) is i * n + j, the
    insertion order (rows, then columns)."""
    edges = [((i - 1) * n + j, i * n + j)
             for i in range(1, m) for j in range(n)]
    edges += [(i * n + j - 1, i * n + j)
              for i in range(m) for j in range(1, n)]
    return edges


def caveman_graph(l: int, k: int) -> Edges:
    """networkx.caveman_graph: l disjoint cliques of size k."""
    if k <= 1:
        return []
    return [e for start in range(0, l * k, k)
            for e in combinations(range(start, start + k), 2)]


def ladder_graph(n: int) -> Edges:
    """networkx.ladder_graph: two paths of n nodes and their rungs."""
    return (_pairwise(range(n)) + _pairwise(range(n, 2 * n))
            + [(v, v + n) for v in range(n)])


def path_graph(n: int) -> Edges:
    return _pairwise(range(n))


def star_graph(n: int) -> Edges:
    """networkx.star_graph: center 0 and n outer nodes."""
    return [(0, i) for i in range(1, n + 1)]


def random_regular_graph(d: int, n: int, rng: random.Random) -> Edges:
    """networkx.random_regular_graph (Steger and Wormald): pair up the d
    copies of every node's stub at random, and re-pair the stubs of the
    pairs that form a self-loop or a repeated edge until none is left, or
    start over when no suitable pair remains."""
    if (n * d) % 2 != 0:
        raise ValueError("n * d must be even")
    if not 0 <= d < n:
        raise ValueError("the 0 <= d < n inequality must be satisfied")
    if d == 0:
        return []

    def suitable(edges, potential_edges) -> bool:
        if not potential_edges:
            return True
        for s1 in potential_edges:
            for s2 in potential_edges:
                if s1 == s2:
                    break
                if s1 > s2:
                    s1, s2 = s2, s1
                if (s1, s2) not in edges:
                    return True
        return False

    def try_creation():
        edges = set()
        stubs = list(range(n)) * d
        while stubs:
            potential_edges = Counter()      # insertion-ordered, as there
            rng.shuffle(stubs)
            stubiter = iter(stubs)
            for s1, s2 in zip(stubiter, stubiter):
                if s1 > s2:
                    s1, s2 = s2, s1
                if s1 != s2 and (s1, s2) not in edges:
                    edges.add((s1, s2))
                else:
                    potential_edges[s1] += 1
                    potential_edges[s2] += 1
            if not suitable(edges, potential_edges):
                return None
            stubs = [node for node, potential in potential_edges.items()
                     for _ in range(potential)]
        return edges

    edges = try_creation()
    while edges is None:
        edges = try_creation()
    return sorted(edges)


# ---- the families ----

def _family(N: int, gtype: GraphType, seed: int, degree: Optional[int],
            rng: np.random.Generator) -> Edges:
    if gtype is GraphType.ERDOS_RENYI:
        deg = degree if degree is not None else rng.integers(1, N)
        return fast_gnp_random_graph(N, deg / N, random.Random(seed))
    if gtype is GraphType.BARABASI_ALBERT:
        deg = degree if degree is not None else int(rng.integers(1, 11))
        return barabasi_albert_graph(N, min(deg, N - 1), random.Random(seed))
    if gtype is GraphType.GRID:
        m = _largest_divisor_leq_sqrt(N)
        return grid_2d_graph(m, N // m)
    if gtype is GraphType.CAVEMAN:
        m = _largest_divisor_leq_sqrt(N)
        return caveman_graph(m, N // m)
    if gtype is GraphType.TREE:
        try:
            return random_powerlaw_tree(N, random.Random(seed),
                                        tries=TREE_TRIES)
        except TreeSequenceError:
            return random_labeled_tree(N, random.Random(seed))
    if gtype is GraphType.LADDER:
        edges = ladder_graph(N // 2)
        if N % 2:
            edges.append((0, N - 1))
        return edges
    if gtype is GraphType.LINE:
        return path_graph(N)
    if gtype is GraphType.STAR:
        return star_graph(N - 1)
    if gtype is GraphType.CATERPILLAR:
        B = int(rng.integers(1, N))
        edges = _pairwise(range(B))
        for i in range(B, N):
            edges.append((i, int(rng.integers(0, B))))
        return edges
    if gtype is GraphType.LOBSTER:
        B = int(rng.integers(1, N))
        F = int(rng.integers(B + 1, N + 1))
        edges = _pairwise(range(B))
        for i in range(B, F):
            edges.append((i, int(rng.integers(0, B))))
        for i in range(F, N):
            edges.append((i, int(rng.integers(B, F))))
        return edges
    raise ValueError(f"unknown graph type {gtype}")


def generate_graph(N: int, gtype: GraphType = GraphType.RANDOM,
                   seed: Optional[int] = None, degree: Optional[int] = None
                   ) -> Tuple[np.ndarray, np.ndarray, GraphType]:
    """Returns (adjacency, U[0,1] node values, concrete family used)."""
    rng = np.random.default_rng(seed)
    if gtype is GraphType.RANDOM:
        types, probs = zip(*MIXTURE)
        gtype = types[int(rng.choice(len(types), p=np.array(probs)))]
    edges = _family(N, gtype, int(rng.integers(1 << 30)), degree, rng)
    A = np.zeros((N, N), dtype=np.float64)
    for u, v in edges:
        if u != v and u < N and v < N:
            A[u, v] = A[v, u] = 1.0
    features = rng.uniform(size=N)
    return A, features, gtype


def adjacency_to_edge_index(A: np.ndarray) -> np.ndarray:
    u, v = np.nonzero(A)
    return np.stack([u, v]).astype(np.int64)
