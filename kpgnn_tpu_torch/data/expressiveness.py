"""Expressiveness benchmark datasets: EXP/CEXP, SR25, CSL (counterpart
of kpgnn_tpu/data/expressiveness.py; reference:
datasets/PlanarSATPairsDataset.py, datasets/SRDataset.py,
train_CSL.py:212-214).

EXP ships as a pickle of torch_geometric Data objects; a tolerant
unpickler maps the PyG classes onto a stub so no PyG install is needed.
CEXP ships as a text file of (label, adjacency-list) blocks.  SR25 is a
graph6 file (15 strongly regular (25,12,5,6) graphs), read by the port's
own graph6 parser (the JAX package reads it with networkx, which the
port does not use).  CSL (circular skip links) graphs are deterministic
— C_41 plus skip-r links for ten values of r — so they are generated
directly instead of downloaded.
"""
from __future__ import annotations

import pickle
from typing import List, Tuple

import numpy as np

GRAPH6_HEADER = b">>graph6<<"


class _StubData:
    """Stand-in for torch_geometric.data.Data during unpickling."""

    def __init__(self, *args, **kw):
        self.__dict__.update(kw)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__.update(dict(state))


class _TolerantUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if module.startswith("torch_geometric"):
            return _StubData
        return super().find_class(module, name)


def _to_np(t):
    if t is None:
        return None
    try:
        return np.asarray(t.detach().cpu().numpy())
    except AttributeError:
        return np.asarray(t)


def load_exp_pickle(path: str) -> List[dict]:
    """EXP/CEXP pickle -> raw graph dicts (x int codes, y class)."""
    with open(path, "rb") as f:
        data_list = _TolerantUnpickler(f).load()
    out = []
    for d in data_list:
        attrs = d.__dict__
        # old PyG keeps tensors either flat or under __dict__['_store']
        store = attrs.get("_store", attrs)
        if hasattr(store, "__dict__"):
            store = store.__dict__
        ei = _to_np(store["edge_index"]).astype(np.int64)
        x = _to_np(store.get("x"))
        y = _to_np(store.get("y"))
        n = int(store.get("num_nodes") or (
            ei.max() + 1 if ei.size else (x.shape[0] if x is not None
                                          else 0)))
        if x is not None and x.ndim == 1:
            x = x[:, None]
        out.append({
            "num_nodes": n,
            "edge_index": ei,
            "x": (x.astype(np.int64) if x is not None
                  else np.zeros((n, 1), np.int64)),
            "y": np.asarray(y).reshape(-1)[:1].astype(np.int64),
        })
    return out


def load_exp_txt(path: str) -> List[dict]:
    """CEXP text format (GIN/S2V style): first line = number of graphs,
    then per graph:
         <num_nodes> <graph_label>
         <node_tag> <num_neighbors> <neighbors...>   (x num_nodes)
    """
    with open(path) as f:
        tokens = f.read().split("\n")
    n_graphs = int(tokens[0].strip())
    out = []
    i = 1
    while i < len(tokens) and len(out) < n_graphs:
        line = tokens[i].strip()
        i += 1
        if not line:
            continue
        n, label = map(int, line.split())
        edges = []
        tags = np.zeros((n, 1), dtype=np.int64)
        for u in range(n):
            row = list(map(int, tokens[i].split()))
            i += 1
            tags[u, 0] = row[0]
            for v in row[2:2 + row[1]]:
                edges.append((u, v))
        ei = (np.array(edges, dtype=np.int64).T if edges
              else np.zeros((2, 0), np.int64))
        out.append({"num_nodes": n, "edge_index": ei, "x": tags,
                    "y": np.array([label], np.int64)})
    return out


def parse_graph6(line: bytes) -> Tuple[int, List[Tuple[int, int]]]:
    """One graph6 string -> (n, edges (i, j) with i < j).  The optional
    ``>>graph6<<`` header is skipped.  N(n) is one byte n + 63 for n <=
    62, else 126 and three bytes (18 bits), or 126 126 and six bytes (36
    bits), 6 bits a byte, big-endian; then the upper triangle, column by
    column ((0,1), (0,2), (1,2), (0,3), ...), 6 bits a byte, each byte
    + 63, the last padded with zeros."""
    data = line.strip()
    if data.startswith(GRAPH6_HEADER):
        data = data[len(GRAPH6_HEADER):]
    vals = [c - 63 for c in data]
    if any(v < 0 or v > 63 for v in vals):
        raise ValueError("graph6 bytes outside 63..126")
    if vals[0] < 63:
        n, head = vals[0], 1
    elif len(vals) > 1 and vals[1] < 63:
        n, head = 0, 4
        for v in vals[1:4]:
            n = (n << 6) | v
    else:
        n, head = 0, 8
        for v in vals[2:8]:
            n = (n << 6) | v
    body = vals[head:]
    n_pairs = n * (n - 1) // 2
    if len(body) != (n_pairs + 5) // 6:
        raise ValueError(f"graph6 body of {len(body)} bytes for n={n}")
    edges = []
    k = 0
    for j in range(1, n):
        for i in range(j):
            if (body[k // 6] >> (5 - k % 6)) & 1:
                edges.append((i, j))
            k += 1
    return n, edges


def read_graph6(path: str) -> List[Tuple[int, List[Tuple[int, int]]]]:
    """Every graph of a graph6 file, one per non-empty line."""
    with open(path, "rb") as f:
        return [parse_graph6(line) for line in f if line.strip()]


def load_sr25(path: str) -> List[dict]:
    """15 strongly-regular graphs; each graph is its own class
    (reference: train_SR.py:196)."""
    out = []
    for i, (n, pairs) in enumerate(read_graph6(path)):
        edges = pairs + [(v, u) for u, v in pairs]
        out.append({
            "num_nodes": n,
            "edge_index": np.array(sorted(edges), dtype=np.int64).T,
            "x": np.zeros((n, 1), np.int64),
            "y": np.array([i], np.int64),
        })
    return out


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
