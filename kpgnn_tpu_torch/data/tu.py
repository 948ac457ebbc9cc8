"""TU graph-kernel benchmark parsers (counterpart of kpgnn_tpu/data/tu.py;
numpy only).

Two on-disk formats:

* the standard TU format (DS_A.txt / DS_graph_indicator.txt /
  DS_graph_labels.txt, optional node labels), used for DD;
* the GIN/S2V text format (``<n> <label>`` then one adjacency row per
  node) with the canonical 10-fold index files, used for
  MUTAG/PTC/PROTEINS/IMDB with the published folds.

Social datasets (IMDB/REDDIT) take node degrees as tags.  Tags and
classes are remapped to dense ranges.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def _read_ints(path):
    with open(path) as f:
        return [list(map(int, l.replace(",", " ").split()))
                for l in f if l.strip()]


def load_tu_standard(root: str, name: str) -> List[dict]:
    """Parse <root>/<name>/raw (or flat <root>/<name>) standard TU files."""
    base = os.path.join(root, name)
    for sub in ("raw", ""):
        d = os.path.join(base, sub)
        if os.path.exists(os.path.join(d, f"{name}_A.txt")):
            base = d
            break
    else:
        raise FileNotFoundError(
            f"TU dataset {name!r} not found under {root} "
            f"(expected {name}_A.txt)")

    def p(suffix):
        return os.path.join(base, f"{name}_{suffix}.txt")

    edges = np.array(_read_ints(p("A")), dtype=np.int64) - 1      # (E, 2)
    indicator = np.array([r[0] for r in _read_ints(p("graph_indicator"))],
                         dtype=np.int64) - 1                       # (N,)
    graph_labels = np.array([r[0] for r in _read_ints(p("graph_labels"))],
                            dtype=np.int64)
    labels_unique = np.unique(graph_labels)
    graph_labels = np.searchsorted(labels_unique, graph_labels)

    node_labels = None
    if os.path.exists(p("node_labels")):
        node_labels = np.array([r[0] for r in _read_ints(p("node_labels"))],
                               dtype=np.int64)
        node_labels -= node_labels.min()

    n_graphs = int(indicator.max()) + 1
    node_offset = np.zeros(n_graphs + 1, dtype=np.int64)
    counts = np.bincount(indicator, minlength=n_graphs)
    node_offset[1:] = np.cumsum(counts)

    graphs: List[dict] = []
    edge_graph = indicator[edges[:, 0]]
    order = np.argsort(edge_graph, kind="stable")
    edges = edges[order]
    edge_graph = edge_graph[order]
    splits = np.searchsorted(edge_graph, np.arange(n_graphs + 1))
    for g in range(n_graphs):
        lo, hi = splits[g], splits[g + 1]
        e = edges[lo:hi] - node_offset[g]
        n = counts[g]
        x = (node_labels[node_offset[g]:node_offset[g + 1], None]
             if node_labels is not None else np.zeros((n, 1), np.int64))
        graphs.append({
            "num_nodes": int(n),
            "edge_index": e.T.copy(),
            "x": x,
            "y": np.array([graph_labels[g]], np.int64),
        })
    return graphs


def load_tu_gin_split(root: str, name: str,
                      degree_as_tag: Optional[bool] = None
                      ) -> Tuple[List[dict],
                                 List[Tuple[np.ndarray, np.ndarray]]]:
    """Parse <root>/<name>/<name>.txt (GIN text format) plus the 10-fold
    index files 10fold_idx/{train,test}_idx-<fold>.txt.  Returns (graphs,
    folds) with folds[i] = (train_idx, test_idx); no folds without the
    index directory."""
    if degree_as_tag is None:
        degree_as_tag = name.upper().startswith(("IMDB", "REDDIT"))
    path = os.path.join(root, name, f"{name}.txt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"GIN-format dataset not found at {path}; place the "
            f"dataset.txt and 10fold_idx there")
    with open(path) as f:
        tokens = f.read().split("\n")
    n_graphs = int(tokens[0].strip())
    graphs = []
    tag_vocab: Dict[int, int] = {}
    i = 1
    for _ in range(n_graphs):
        while not tokens[i].strip():
            i += 1
        n, label = map(int, tokens[i].split())
        i += 1
        tags = np.zeros(n, dtype=np.int64)
        edges = []
        for u in range(n):
            row = list(map(int, tokens[i].split()))
            i += 1
            tags[u] = row[0]
            for v in row[2:2 + row[1]]:
                edges.append((u, v))
        ei = (np.array(edges, dtype=np.int64).T if edges
              else np.zeros((2, 0), np.int64))
        if degree_as_tag:
            tags = np.bincount(ei[0], minlength=n).astype(np.int64) \
                if ei.size else np.zeros(n, np.int64)
        for t in tags:
            tag_vocab.setdefault(int(t), len(tag_vocab))
        graphs.append({"num_nodes": n, "edge_index": ei, "tags": tags,
                       "y": np.array([label], np.int64)})
    # tags to a dense vocabulary, in order of first appearance
    for g in graphs:
        g["x"] = np.array([[tag_vocab[int(t)]] for t in g.pop("tags")],
                          dtype=np.int64)
    # classes to 0 .. C-1 in sorted order
    classes = sorted({int(g["y"][0]) for g in graphs})
    cmap = {c: i for i, c in enumerate(classes)}
    for g in graphs:
        g["y"] = np.array([cmap[int(g["y"][0])]], np.int64)

    folds = []
    fold_dir = os.path.join(root, name, "10fold_idx")
    if os.path.exists(fold_dir):
        for f in range(1, 11):
            tr = np.array([r[0] for r in _read_ints(
                os.path.join(fold_dir, f"train_idx-{f}.txt"))], np.int64)
            te = np.array([r[0] for r in _read_ints(
                os.path.join(fold_dir, f"test_idx-{f}.txt"))], np.int64)
            folds.append((tr, te))
    return graphs, folds


def num_tag_classes(graphs: List[dict]) -> int:
    return int(max(int(g["x"].max()) for g in graphs)) + 1
