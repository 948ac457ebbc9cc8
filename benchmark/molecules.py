"""Raw molecule generators: the benchmark's traffic data.

Each generator draws a list of raw molecules (dicts of ``num_nodes``,
``edge_index`` (2, E) with both directions of every bond, ``edge_attr``
(E,) bond codes >= 2, ``x``, ``y`` and, for QM9, ``z``) from one seed.
Nothing here is k-hop prepped: the program preps what it is given, and
``reference/prep.py`` preps the same dicts again on its own.

``zinc`` is a copy of the raw part of the port's
``data/synthetic.synthetic_molecules`` (9-37 heavy atoms, a random
spanning tree plus a few extra bonds, 21 atom types, 3 bond types), kept
here so that a change to the program cannot change the traffic.
``qm9`` is QM9-shaped: 1-9 heavy atoms (C, N, O, F) with hydrogens
filling their valences, 3-29 atoms in all, 4 bond types, the 11 node
features of the PyG QM9 set and atomic numbers as ``z``; its size and
type distributions are assumptions, listed in the configuration files
(its molecules average 22 atoms, QM9's 18).

Every molecule's target is distinct within a library, so that the
targets of a batch name the molecules in it.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np


def rng_for(seed: int, stream: int = 0) -> np.random.Generator:
    """A numpy generator for ``seed`` (any integer, negative or past 64
    bits included) and a stream number, so that the parts of a run draw
    independently of each other."""
    return np.random.default_rng([seed % (1 << 64), stream])


def _random_connected(n: int, rng) -> np.ndarray:
    """A random connected sparse undirected graph as (2, E) directed
    pairs: a random spanning tree plus a few extra edges."""
    edges = set()
    perm = rng.permutation(n)
    for i in range(1, n):
        u = int(perm[rng.integers(0, i)])
        v = int(perm[i])
        edges.add((min(u, v), max(u, v)))
    extra = int(rng.integers(0, max(2, n // 4)))
    for _ in range(extra):
        u, v = int(rng.integers(0, n)), int(rng.integers(0, n))
        if u != v:
            edges.add((min(u, v), max(u, v)))
    e = np.array(sorted(edges), dtype=np.int64)
    return np.concatenate([e, e[:, ::-1]], axis=0).T


def zinc(n_graphs: int, rng, n_min: int = 9, n_max: int = 37,
         num_atom_types: int = 21, num_bond_types: int = 3) -> List[Dict]:
    """ZINC-shaped molecules: x (n, 1) atom codes, bond codes 2..4, one
    regression target."""
    out = []
    for _ in range(n_graphs):
        n = int(rng.integers(n_min, n_max + 1))
        ei = _random_connected(n, rng)
        e = ei.shape[1]
        ea = np.zeros(e, dtype=np.int64)
        half = e // 2
        t = rng.integers(2, num_bond_types + 2, size=half)
        ea[:half] = t
        ea[half:] = t
        x = rng.integers(0, num_atom_types, size=(n, 1)).astype(np.int64)
        y = np.array([rng.normal()], dtype=np.float32)
        out.append({"num_nodes": n, "edge_index": ei, "edge_attr": ea,
                    "x": x, "y": y})
    return out


# heavy-atom count 1..9: weights of the benchmark's own choosing, skewed
# to 9 heavy atoms as QM9 is, from no published count
QM9_HEAVY_WEIGHTS = np.array([3, 5, 12, 44, 151, 689, 3314, 21000, 110000],
                             dtype=np.float64)
QM9_ELEMENTS = ("C", "N", "O", "F")
QM9_ELEMENT_WEIGHTS = np.array([0.70, 0.12, 0.16, 0.02])
QM9_TYPE_INDEX = {"H": 0, "C": 1, "N": 2, "O": 3, "F": 4}
QM9_Z = {"H": 1, "C": 6, "N": 7, "O": 8, "F": 9}
QM9_VALENCE = {"C": 4, "N": 3, "O": 2, "F": 1}
# heavy-heavy bond codes single, double, triple, aromatic (2..5)
QM9_BOND_WEIGHTS = np.array([0.75, 0.15, 0.03, 0.07])
QM9_MAX_ATOMS = 29


def qm9(n_graphs: int, rng) -> List[Dict]:
    """QM9-shaped molecules with hydrogens: x (n, 11) = one-hot type (H,
    C, N, O, F), atomic number, aromatic, sp, sp2, sp3, number of
    hydrogens; z the atomic numbers; bond codes 2..5; one target."""
    out = []
    hw = QM9_HEAVY_WEIGHTS / QM9_HEAVY_WEIGHTS.sum()
    for _ in range(n_graphs):
        heavy = int(rng.choice(9, p=hw)) + 1
        elems = [QM9_ELEMENTS[i] for i in
                 rng.choice(4, size=heavy, p=QM9_ELEMENT_WEIGHTS)]
        bonds = {}
        if heavy > 1:
            ei = _random_connected(heavy, rng)
            half = ei.shape[1] // 2
            codes = rng.choice(4, size=half, p=QM9_BOND_WEIGHTS) + 2
            for (u, v), c in zip(ei[:, :half].T, codes):
                bonds[(int(u), int(v))] = int(c)
        used = np.zeros(heavy, np.int64)
        for (u, v), c in bonds.items():
            order = {2: 1, 3: 2, 4: 3, 5: 1}[c]
            used[u] += order
            used[v] += order
        n_h = [max(0, QM9_VALENCE[e] - int(used[i]))
               for i, e in enumerate(elems)]
        room = QM9_MAX_ATOMS - heavy
        while sum(n_h) > room:
            n_h[int(np.argmax(n_h))] -= 1
        syms = list(elems)
        for i, k in enumerate(n_h):
            for _ in range(k):
                bonds[(i, len(syms))] = 2
                syms.append("H")
        while len(syms) < 3:                # QM9's smallest has 3 atoms
            bonds[(0, len(syms))] = 2
            syms.append("H")
        n = len(syms)
        pairs = sorted(bonds.items())
        row = [u for (u, v), _ in pairs] + [v for (u, v), _ in pairs]
        col = [v for (u, v), _ in pairs] + [u for (u, v), _ in pairs]
        ea = [c for _, c in pairs] * 2
        ei = np.array([row, col], np.int64)
        ea = np.array(ea, np.int64)
        z = np.array([QM9_Z[s] for s in syms], np.int64)
        aromatic = np.zeros(n, np.float32)
        for (u, v), c in pairs:
            if c == 5:
                aromatic[u] = aromatic[v] = 1.0
        num_hs = np.zeros(n, np.float32)
        np.add.at(num_hs, ei[1], (z[ei[0]] == 1).astype(np.float32))
        x1 = np.eye(5, dtype=np.float32)[[QM9_TYPE_INDEX[s] for s in syms]]
        x2 = np.stack([z.astype(np.float32), aromatic,
                       np.zeros(n, np.float32), np.zeros(n, np.float32),
                       np.zeros(n, np.float32), num_hs], axis=1)
        out.append({"num_nodes": n, "edge_index": ei, "edge_attr": ea,
                    "x": np.concatenate([x1, x2], axis=1), "z": z,
                    "y": np.array([rng.normal()], dtype=np.float32)})
    return out


GENERATORS = {"zinc": zinc, "qm9": qm9}


def distinct_targets(mols: List[Dict]) -> List[Dict]:
    """Move each target that repeats an earlier one up by one float32
    step until none repeats (in place)."""
    seen = set()
    for m in mols:
        y = np.asarray(m["y"], np.float32)
        while float(y[0]) in seen:
            y = y.copy()
            y[0] = np.nextafter(y[0], np.float32(np.inf))
        m["y"] = y
        seen.add(float(y[0]))
    return mols


def generate(kind: str, n_graphs: int, seed: int) -> List[Dict]:
    """``n_graphs`` raw molecules of ``kind`` ("zinc" or "qm9") from
    ``seed``, their targets distinct."""
    return distinct_targets(GENERATORS[kind](n_graphs, rng_for(seed, 0)))
