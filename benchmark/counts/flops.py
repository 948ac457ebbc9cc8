"""Model FLOPs of a step on a batch's real nodes and edges: the forward
counted by ``counts/<model_name in lower case>.py``'s
``forward_flops(m, n, g, edges)``; a training step counts 3x the forward
(the backward's two products per forward product)."""
from __future__ import annotations

import importlib
from typing import Sequence


def forward_flops(m: dict, n: int, g: int, edges: Sequence[int]) -> float:
    mod = importlib.import_module(
        f"{__package__}.{m['model_name'].lower()}")
    return mod.forward_flops(m, n, g, edges)


def step_flops(m: dict, n: int, g: int, edges: Sequence[int],
               train: bool) -> float:
    return forward_flops(m, n, g, edges) * (3.0 if train else 1.0)
