"""OGB graph-property-prediction loader (counterpart of
kpgnn_tpu/data/ogb.py; reference: datasets/pyg_dataset.py, the
PygGraphPropPredDataset wrapper).

Parses the standard OGB raw CSV layout without the ogb package, each
file plain or gzipped:

    <root>/raw/num-node-list.csv[.gz]   nodes per graph
    <root>/raw/num-edge-list.csv[.gz]   edges per graph
    <root>/raw/edge.csv[.gz]            (E_total, 2) edge list
    <root>/raw/node-feat.csv[.gz]       (N_total, F) optional
    <root>/raw/edge-feat.csv[.gz]       (E_total, Fe) optional
    <root>/raw/graph-label.csv[.gz]     (G, T); an empty cell is nan
    <root>/split/<name>/{train,valid,test}.csv[.gz]

Molecule datasets store the bond type in edge-feat column 0; it is
offset by +2 so the 0/1-reserved attr contract holds.
"""
from __future__ import annotations

import gzip
import os
from typing import Dict, List

import numpy as np


def _read_csv(path, dtype=np.int64):
    if not os.path.exists(path) and not path.endswith(".gz"):
        path = path + ".gz"
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    if dtype == np.float32:
        # multi-task label files leave unknown entries as empty cells
        # (e.g. ogbg-molpcba); represent them as nan
        rows = [[c if c else "nan" for c in r] for r in rows]
    return np.array(rows, dtype=dtype)


def _maybe(path, dtype):
    for p in (path, path + ".gz"):
        if os.path.exists(p):
            return _read_csv(p, dtype)
    return None


def load_ogb_graphpred(root: str, split_name: str = "scaffold"
                       ) -> Dict[str, object]:
    """Returns {"graphs": [raw dicts], "splits": {train/valid/test: idx}}."""
    raw = os.path.join(root, "raw")
    if not (os.path.exists(os.path.join(raw, "num-node-list.csv")) or
            os.path.exists(os.path.join(raw, "num-node-list.csv.gz"))):
        raise FileNotFoundError(
            f"OGB raw data not found under {raw}; place the dataset's "
            "raw/ CSVs there")
    n_nodes = _read_csv(os.path.join(raw, "num-node-list.csv"))[:, 0]
    n_edges = _read_csv(os.path.join(raw, "num-edge-list.csv"))[:, 0]
    edges = _read_csv(os.path.join(raw, "edge.csv"))
    node_feat = _maybe(os.path.join(raw, "node-feat.csv"), np.int64)
    edge_feat = _maybe(os.path.join(raw, "edge-feat.csv"), np.int64)
    labels = _maybe(os.path.join(raw, "graph-label.csv"), np.float32)

    graphs: List[dict] = []
    n_off = e_off = 0
    for g in range(len(n_nodes)):
        n, e = int(n_nodes[g]), int(n_edges[g])
        ei = edges[e_off:e_off + e].T
        d = {
            "num_nodes": n,
            "edge_index": ei.astype(np.int64),
            "x": (node_feat[n_off:n_off + n] if node_feat is not None
                  else np.zeros((n, 1), np.int64)),
            "y": labels[g] if labels is not None else None,
        }
        if edge_feat is not None and e:
            # bond-type column, +2 offset for the 0/1-reserved contract
            d["edge_attr"] = edge_feat[e_off:e_off + e, 0] + 2
        graphs.append(d)
        n_off += n
        e_off += e

    splits = {}
    sdir = os.path.join(root, "split", split_name)
    for part in ("train", "valid", "test"):
        arr = _maybe(os.path.join(sdir, f"{part}.csv"), np.int64)
        if arr is not None:
            splits[part] = arr[:, 0]
    return {"graphs": graphs, "splits": splits}
