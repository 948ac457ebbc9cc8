"""ZINC and QM9 molecule loaders (counterpart of
kpgnn_tpu/data/molecules.py).

Both parse the standard raw artifacts when they are on disk (there is no
downloader):

* ZINC: ``<root>/raw/{split}.pickle`` (+ ``{split}.index`` for the 12k
  subset).  Bond types are offset by +1 so values start at 2 (prep
  contract: 0 = mask, 1 = self-loop).
* QM9: ``<root>/raw/qm9_v3.pt`` (PyG's preprocessed tensor dump), or the
  raw gdb9 artifacts through a pure-python V2000 SDF parser.  Bond codes
  are offset by +2; targets are in the reference's order and units
  (``qm9_reorder_and_convert``).

The pickles and tensor dumps are trusted local files.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np
import torch

HAR2EV = 27.211386246
KCALMOL2EV = 0.04336414

# per-target unit conversion, indexed in the reference's target order
QM9_CONVERSION = np.array([
    1., 1., HAR2EV, HAR2EV, HAR2EV, 1., HAR2EV, HAR2EV, HAR2EV, HAR2EV,
    HAR2EV, 1., KCALMOL2EV, KCALMOL2EV, KCALMOL2EV, KCALMOL2EV, 1., 1., 1.
], dtype=np.float64)


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


def load_qm9(root: str, targets_raw_order: bool = False) -> List[dict]:
    """Returns raw graph dicts with x (11 continuous features), z (atom
    codes), pos, edge_attr (bond type + 2), y (19 targets in reference
    ordering and units).

    ``targets_raw_order=False`` (default) loads the dump's y untouched:
    PyG's official qm9_v3.pt ships y already reordered [3:]+[:3] and
    unit-converted, and the reference's non-rdkit branch loads it as-is
    (reference: datasets/QM9Dataset.py:197-211) — re-applying the
    transform would double-convert Hartree->eV and map task indices to
    the wrong physical target.  Pass True only for a dump whose y rows
    are still in raw gdb9 CSV order/units; then
    `qm9_reorder_and_convert` is applied so task indices match the
    reference protocol (reference: datasets/QM9Dataset.py:222-223)."""
    path = os.path.join(root, "raw", "qm9_v3.pt")
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"QM9 preprocessed dump not found at {path}; place PyG's "
            "qm9_v3.pt there (the rdkit raw path is not supported)")
    data_list = torch.load(path, weights_only=False)
    graphs = []
    for d in data_list:
        if not isinstance(d, dict):
            d = d.__dict__
        ei = _np(d["edge_index"]).astype(np.int64)
        # qm9_v3 stores one-hot bond types; code = argmax, then +2 offset
        ea = _np(d["edge_attr"])
        ea = (ea.argmax(axis=1) if ea.ndim == 2 else ea).astype(np.int64) + 2
        y = _np(d["y"]).astype(np.float64).reshape(-1)[:19]
        if targets_raw_order:
            y = qm9_reorder_and_convert(y)
        graphs.append({
            "num_nodes": int(_np(d["x"]).shape[0]),
            "edge_index": ei,
            "edge_attr": ea,
            "x": _np(d["x"]).astype(np.float32),
            "z": _np(d["z"]).astype(np.int64),
            "pos": _np(d["pos"]).astype(np.float32),
            "y": y.astype(np.float32),
        })
    return graphs


def _parse_sdf_v2000(text: str):
    """Minimal V2000 molfile parser for one SDF record: returns
    (symbols, pos (N,3) float, bonds [(a, b, type)], ok)."""
    lines = text.split("\n")
    counts = lines[3]
    try:
        n_atoms = int(counts[0:3])
        n_bonds = int(counts[3:6])
    except ValueError:
        return None
    syms, pos = [], []
    for ln in lines[4:4 + n_atoms]:
        parts = ln.split()
        pos.append([float(v) for v in parts[:3]])
        syms.append(parts[3])
    bonds = []
    for ln in lines[4 + n_atoms:4 + n_atoms + n_bonds]:
        # fixed-width fields (atom indices can touch at >= 100 atoms)
        a = int(ln[0:3]) - 1
        b = int(ln[3:6]) - 1
        t = int(ln[6:9])
        bonds.append((a, b, t))
    return syms, np.asarray(pos, np.float32), bonds


QM9_TYPES = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}
QM9_ATOMIC_NUM = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}


def load_qm9_raw(root: str) -> List[dict]:
    """Build QM9 from the raw gdb9 artifacts with a pure-python V2000
    SDF parser — no rdkit needed (the reference requires rdkit for this
    path, reference: datasets/QM9Dataset.py:186-299; its features are
    reproduced exactly for unsanitized molecules: one-hot atom type,
    atomic number, aromatic flag from bond-type-4 annotations,
    sp/sp2/sp3 = 0 — rdkit leaves hybridization UNSPECIFIED under
    sanitize=False — and H-neighbor counts).

    Expects <root>/raw/gdb9.sdf, gdb9.sdf.csv, uncharacterized.txt.
    Returns the same graph-dict schema as load_qm9 (y reordered [3:]+[ :3]
    and unit-converted, edge_attr = bond code + 2).
    """
    raw = os.path.join(root, "raw")
    sdf = os.path.join(raw, "gdb9.sdf")
    csv = os.path.join(raw, "gdb9.sdf.csv")
    unc = os.path.join(raw, "uncharacterized.txt")
    if not (os.path.exists(sdf) and os.path.exists(csv)):
        raise FileNotFoundError(
            f"QM9 raw artifacts not found under {raw}: expected gdb9.sdf "
            "+ gdb9.sdf.csv (+ uncharacterized.txt)")
    with open(csv) as f:
        rows = f.read().split("\n")[1:-1]
    target = np.asarray([[float(v) for v in ln.split(",")[1:20]]
                         for ln in rows], np.float64)
    target = np.concatenate([target[:, 3:], target[:, :3]], axis=1)
    target = target * QM9_CONVERSION[None, :]
    skip = set()
    if os.path.exists(unc):
        with open(unc) as f:
            skip = {int(x.split()[0]) - 1
                    for x in f.read().split("\n")[9:-2]}

    with open(sdf) as f:
        records = f.read().split("$$$$\n")
    graphs = []
    for i, rec in enumerate(records):
        if i in skip or not rec.strip():
            continue
        parsed = _parse_sdf_v2000(rec)
        if parsed is None:
            continue
        syms, pos, bonds = parsed
        n = len(syms)
        z = np.asarray([QM9_ATOMIC_NUM[s] for s in syms], np.int64)
        type_idx = np.asarray([QM9_TYPES[s] for s in syms], np.int64)
        row, col, et = [], [], []
        aromatic = np.zeros(n, np.float32)
        for a, b, t in bonds:
            row += [a, b]
            col += [b, a]
            et += 2 * [t - 1]            # SDF 1/2/3/4 -> 0/1/2/3 codes
            if t == 4:
                aromatic[a] = aromatic[b] = 1.0
        ei = np.asarray([row, col], np.int64)
        et = np.asarray(et, np.int64)
        perm = np.argsort(ei[0] * n + ei[1], kind="stable")
        ei, et = ei[:, perm], et[perm]
        hs = (z == 1).astype(np.float32)
        num_hs = np.zeros(n, np.float32)
        np.add.at(num_hs, ei[1], hs[ei[0]])
        x1 = np.eye(len(QM9_TYPES), dtype=np.float32)[type_idx]
        x2 = np.stack([z.astype(np.float32), aromatic,
                       np.zeros(n, np.float32),     # sp
                       np.zeros(n, np.float32),     # sp2
                       np.zeros(n, np.float32),     # sp3
                       num_hs], axis=1)
        graphs.append({
            "num_nodes": n,
            "edge_index": ei,
            "edge_attr": et + 2,
            "x": np.concatenate([x1, x2], axis=1),
            "z": z,
            "pos": pos,
            "y": target[i].astype(np.float32),
        })
    return graphs


def qm9_reorder_and_convert(target: np.ndarray) -> np.ndarray:
    """Raw 19-target row -> reference ordering and units: columns [3:]
    then [:3], scaled by the per-target unit conversion (Hartree->eV,
    kcal/mol->eV), conversion indexed in the NEW order
    (reference: datasets/QM9Dataset.py:20-26,222-223)."""
    t = np.concatenate([target[3:], target[:3]])
    return t * QM9_CONVERSION


# Per-atom reference energies (eV) for thermochemical targets, indexed
# by target id in the processed ordering; rows are atom types H/C/N/O/F
# (reference: datasets/QM9Dataset.py:28-47 — dataset API only, no
# training script consumes it there either).
QM9_ATOMREFS = {
    6: [0.0, 0.0, 0.0, 0.0, 0.0],
    7: [-13.61312172, -1029.86312267, -1485.30251237, -2042.61123593,
        -2713.48485589],
    8: [-13.5745904, -1029.82456413, -1485.26398105, -2042.5727046,
        -2713.44632457],
    9: [-13.54887564, -1029.79887659, -1485.2382935, -2042.54701705,
        -2713.42063702],
    10: [-13.90303183, -1030.25891228, -1485.71166277, -2043.01812778,
         -2713.88796536],
    11: [0.0, 0.0, 0.0, 0.0, 0.0],
}


def qm9_atomref(target: int):
    """(100, 1) per-atomic-number reference values for `target`, or None
    when the target has no atomref — same contract as the reference's
    QM9.atomref (datasets/QM9Dataset.py:152-157).  Subtracting
    `atomref[z].sum()` per molecule converts total energies to
    atomization energies."""
    if target not in QM9_ATOMREFS:
        return None
    out = np.zeros((100, 1), np.float32)
    out[[1, 6, 7, 8, 9], 0] = QM9_ATOMREFS[target]
    return out
