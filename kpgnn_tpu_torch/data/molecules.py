"""ZINC molecule loader (counterpart of kpgnn_tpu/data/molecules.py;
QM9 is not ported yet).

Parses the standard raw bundle when it is on disk (there is no
downloader): ``<root>/raw/{split}.pickle`` (+ ``{split}.index`` for the
12k subset).  Bond types are offset by +1 so values start at 2 (prep
contract: 0 = mask, 1 = self-loop).
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np


def _np(t):
    try:
        return t.detach().cpu().numpy()
    except AttributeError:
        return np.asarray(t)


def load_zinc(root: str, subset: bool = True,
              splits=("train", "val", "test")) -> Dict[str, List[dict]]:
    """Returns {split: [raw graph dicts]} with x = atom-type codes,
    edge_attr = bond type + 1 (>= 2), y = penalized logP.  The pickles
    are trusted local files (the molecules bundle format)."""
    raw = os.path.join(root, "raw")
    if not os.path.exists(os.path.join(raw, "train.pickle")):
        raise FileNotFoundError(
            f"ZINC raw data not found under {raw}: expected "
            "{train,val,test}.pickle (+ .index for the subset); place the "
            "ZINC molecules bundle there")
    out: Dict[str, List[dict]] = {}
    for split in splits:
        with open(os.path.join(raw, f"{split}.pickle"), "rb") as f:
            mols = pickle.load(f)
        indices = range(len(mols))
        idx_path = os.path.join(raw, f"{split}.index")
        if subset and os.path.exists(idx_path):
            with open(idx_path) as f:
                indices = [int(x) for x in
                           f.read().strip().rstrip(",").split(",")]
        graphs = []
        for i in indices:
            mol = mols[i]
            x = _np(mol["atom_type"]).astype(np.int64).reshape(-1, 1)
            y = np.asarray(_np(mol["logP_SA_cycle_normalized"]),
                           np.float32).reshape(-1)[:1]
            adj = _np(mol["bond_type"])
            u, v = np.nonzero(adj)
            ea = adj[u, v].astype(np.int64) + 1
            graphs.append({
                "num_nodes": int(x.shape[0]),
                "edge_index": np.stack([u, v]).astype(np.int64),
                "edge_attr": ea,
                "x": x,
                "y": y,
            })
        out[split] = graphs
    return out
