"""Cross-validation splits (counterpart of kpgnn_tpu/train/kfold.py).

k_fold: stratified folds where fold i's validation set is fold i-1's
test set, the reference protocol; k_fold_unstratified: the same on a
seeded permutation.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def _stratified_folds(labels: np.ndarray, folds: int, seed: int = 12345):
    """Deterministic stratified fold assignment: per-class round-robin
    after a seeded shuffle."""
    rng = np.random.default_rng(seed)
    assign = np.zeros(len(labels), dtype=np.int64)
    for c in np.unique(labels):
        idx = np.flatnonzero(labels == c)
        rng.shuffle(idx)
        for i, j in enumerate(idx):
            assign[j] = i % folds
    return assign


def k_fold(n: int, labels: Sequence, folds: int = 10, seed: int = 12345
           ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """[(train_idx, val_idx, test_idx)] per fold; val is the previous
    fold's test."""
    if folds < 3:
        raise ValueError(f"k_fold needs folds >= 3: val is the previous "
                         f"fold's test, so folds={folds} leaves no "
                         "training data")
    assign = _stratified_folds(np.asarray(labels), folds, seed)
    test_sets = [np.flatnonzero(assign == f) for f in range(folds)]
    out = []
    for f in range(folds):
        test, val = test_sets[f], test_sets[f - 1]
        mask = np.ones(n, dtype=bool)
        mask[test] = False
        mask[val] = False
        out.append((np.flatnonzero(mask), val, test))
    return out


def k_fold_unstratified(n: int, folds: int = 10, seed: int = 12345
                        ) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """[(train_idx, val_idx, test_idx)] per fold of a seeded
    permutation cut into ``folds`` parts; val is the previous fold's
    test."""
    perm = np.random.default_rng(seed).permutation(n)
    test_sets = [np.sort(t) for t in np.array_split(perm, folds)]
    out = []
    for f in range(folds):
        test, val = test_sets[f], test_sets[f - 1]
        mask = np.ones(n, dtype=bool)
        mask[test] = False
        mask[val] = False
        out.append((np.flatnonzero(mask), val, test))
    return out
