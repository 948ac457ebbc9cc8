"""Generated expressiveness benchmarks (counterpart of
kpgnn_tpu/data/expressiveness.py; numpy only).  This slice has CSL; EXP
and SR25 need raw files and are not ported yet."""
from __future__ import annotations

from typing import List

import numpy as np

CSL_SKIPS = (2, 3, 4, 5, 6, 9, 11, 12, 13, 16)


def generate_csl(n: int = 41, copies: int = 15, seed: int = 0) -> List[dict]:
    """Circular-skip-link graphs: C_n plus skip-r edges; class = r.  The
    standard benchmark is 10 classes x 15 relabeled copies of 41-node
    graphs (the content of PyG's GNNBenchmarkDataset('CSL'))."""
    rng = np.random.default_rng(seed)
    out = []
    for cls, r in enumerate(CSL_SKIPS):
        base = set()
        for i in range(n):
            base.add(tuple(sorted((i, (i + 1) % n))))
            base.add(tuple(sorted((i, (i + r) % n))))
        for c in range(copies):
            perm = np.arange(n) if c == 0 else rng.permutation(n)
            edges = []
            for u, v in base:
                pu, pv = int(perm[u]), int(perm[v])
                edges.append((pu, pv))
                edges.append((pv, pu))
            out.append({
                "num_nodes": n,
                "edge_index": np.array(sorted(set(edges)), dtype=np.int64).T,
                "x": np.zeros((n, 1), np.int64),
                "y": np.array([cls], np.int64),
            })
    return out
