"""Seeding (counterpart of kpgnn_tpu/utils/seed.py).

The reference derives per-run seeds from wall-clock microsecond entropy
(reference: train_utils.py:379-386), which makes bitwise reproduction
impossible; here runs derive deterministically from a base seed, with the
entropy path kept available behind ``time_based=True``.
"""
from __future__ import annotations

import random
import time

import numpy as np
import torch


def get_seed(base: int = 234, run: int = 0, time_based: bool = False) -> int:
    if time_based:
        t = int(time.time() * 1e6) % 4096
        return int(t * base) % (2**31 - 1)
    return (base * 1_000_003 + run * 7919) % (2**31 - 1)


def seed_everything(seed: int) -> int:
    """Seeds Python's and numpy's global streams as the JAX package does,
    and torch's default generators (CPU and every CUDA device)."""
    random.seed(seed)
    np.random.seed(seed % (2**32 - 1))
    torch.manual_seed(seed)
    return seed
