"""Graph and node property dataset, self-generating, PNA-style
(counterpart of kpgnn_tpu/data/property.py; numpy only).

Node labels: [sssp distance from a random source, eccentricity,
Laplacian features L @ F]; graph labels: [is_connected, diameter,
spectral radius].  Labels are divided by their max over the train split;
node features are [one-hot(source), U(0,1) value].
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from . import algorithms as alg
from .generation import GraphType, adjacency_to_edge_index, generate_graph


def _one_graph(N: int, seed: int, rng: np.random.Generator):
    s = seed
    adj, features, gtype = generate_graph(N, GraphType.RANDOM, seed=s)
    while adj.max(axis=0).min() == 0.0:      # reject singleton nodes
        s += 1
        adj, features, _ = generate_graph(N, gtype, seed=s)
    source = int(rng.integers(0, N))
    sssp = alg.sssp_dist(adj, source)
    node_labels = np.stack([
        sssp,
        alg.eccentricity(adj),
        alg.graph_laplacian_features(adj, features),
    ], axis=1).astype(np.float32)                      # (N, 3)
    graph_labels = np.array([
        alg.is_connected(adj),
        alg.diameter(adj),
        alg.spectral_radius(adj),
    ], dtype=np.float32)                               # (3,)
    onehot = np.zeros(N, dtype=np.float32)
    onehot[source] = 1.0
    x = np.stack([onehot, features.astype(np.float32)], axis=1)   # (N, 2)
    return adj, x, node_labels, graph_labels


def generate_property_dataset(seed: int = 1234,
                              scale: float = 1.0) -> Dict[str, List[dict]]:
    """Splits of 5120 / 640 / 1280 graphs (train in ten groups of N = 15
    .. 24 nodes, val and test in five of N = 15 .. 19).  Returns raw-graph
    dicts with node labels (key 'node_y') and graph labels (key 'y'),
    each divided by its train-split max.  ``scale`` shrinks every group
    (at least one graph each)."""
    rng = np.random.default_rng(seed)
    per = lambda n: max(1, int(round(n * scale)))
    sizes = {
        "train": [per(512)] * 10,
        "val": [per(128)] * 5,
        "test": [per(256)] * 5,
    }
    N_range = list(range(15, 25))
    raw = {k: [] for k in sizes}
    s = seed
    for split, batches in sizes.items():
        for batch_idx, count in enumerate(batches):
            N = N_range[batch_idx % len(N_range)]
            for _ in range(count):
                s += 1
                adj, x, nl, gl = _one_graph(N, s, rng)
                raw[split].append({
                    "num_nodes": N,
                    "edge_index": adjacency_to_edge_index(adj),
                    "x": x, "node_y": nl, "y": gl,
                })

    max_node = np.max(np.stack(
        [g["node_y"].max(axis=0) for g in raw["train"]]), axis=0)
    max_graph = np.max(np.stack(
        [g["y"] for g in raw["train"]]), axis=0)
    max_node = np.where(max_node == 0, 1.0, max_node)
    max_graph = np.where(max_graph == 0, 1.0, max_graph)
    for split in raw:
        for g in raw[split]:
            g["node_y"] = (g["node_y"] / max_node).astype(np.float32)
            g["y"] = (g["y"] / max_graph).astype(np.float32)
    return raw
