"""Substructure-counting dataset with closed-form ground truth
(counterpart of kpgnn_tpu/data/counting.py; numpy only).

Erdős–Rényi graphs of 10..20 nodes without singleton nodes, labels
computed from powers of A (``algorithms.substructure_counts``), and a
fixed 30/20/50 split.  The training script standardizes the labels.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from .algorithms import substructure_counts
from .generation import adjacency_to_edge_index

TASKS = ["triangle", "tailed_triangle", "star", "cycle4", "custom"]


def generate_counting_dataset(n_graphs: int = 1500, seed: int = 1234
                              ) -> Dict[str, List[dict]]:
    rng = np.random.default_rng(seed)
    graphs = []
    while len(graphs) < n_graphs:
        n = int(rng.integers(10, 21))
        p = rng.uniform(0.25, 0.5)
        A = (rng.uniform(size=(n, n)) < p).astype(np.float64)
        A = np.triu(A, 1)
        A = A + A.T
        if A.max(axis=0).min() == 0:     # no singleton nodes
            continue
        y = substructure_counts(A).astype(np.float32)
        graphs.append({
            "num_nodes": n,
            "edge_index": adjacency_to_edge_index(A),
            "x": np.ones((n, 1), dtype=np.int64),
            "y": y,
        })
    n_train = int(0.3 * n_graphs)
    n_val = int(0.2 * n_graphs)
    return {
        "train": graphs[:n_train],
        "val": graphs[n_train:n_train + n_val],
        "test": graphs[n_train + n_val:],
    }
