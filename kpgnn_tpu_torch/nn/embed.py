"""Embedding lookups with the framework's index semantics (counterpart of
kpgnn_tpu/nn/embed.py).

Lookups from tables of at most 64 rows are one-hot matmuls, as in the
JAX package, so an id outside [0, V) reads a zero row; wider tables
gather with JAX's clamped indexing.  Index 0 is the mask value
throughout, and ``PaddedEmbed`` pins that row to zero in the forward pass
(torch's ``padding_idx`` semantics, gradient included).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .inits import normal_

ONEHOT_MAX_ROWS = 64


def small_table_lookup(table: torch.Tensor, ids: torch.Tensor,
                       max_rows: int = ONEHOT_MAX_ROWS) -> torch.Tensor:
    """``table[ids]`` that differentiates as a matmul, not a scatter.

    Up to ``max_rows`` rows the lookup is one_hot(ids) @ table: exact in
    the forward pass (one 1 per row, full-f32 matmul), and its backward is
    one (V, N) @ (N, D) matmul.  The backward of an indexing gather
    (``table[ids]``) is a scatter that serialises on repeated ids (every
    padded node reads row 0); on an H100 the flagship step spent most of
    its device time there (PERF.md, Findings).  Wider tables go through
    ``F.embedding``, whose backward sums the rows of each repeated id in
    parallel (CSL's path encodings, where every node reads the same few
    of 1,000 rows, PERF.md)."""
    V = table.shape[0]
    ids = ids.long()
    if V > max_rows:
        return F.embedding(ids.clamp(0, V - 1), table)
    oh = ids[..., None] == torch.arange(V, device=ids.device)
    return oh.to(table.dtype) @ table


def zero_row(table: torch.Tensor, row: int = 0) -> torch.Tensor:
    """``table`` with one row replaced by zeros, out of place."""
    mask = torch.ones(table.shape[0], 1, dtype=table.dtype,
                      device=table.device)
    mask[row] = 0.0
    return table * mask


class PaddedEmbed(nn.Module):
    def __init__(self, num_embeddings: int, features: int,
                 padding_idx: Optional[int] = 0):
        super().__init__()
        self.padding_idx = padding_idx
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def init_params(self, generator: torch.Generator) -> None:
        normal_(self.weight, generator)

    def table(self) -> torch.Tensor:
        if self.padding_idx is None:
            return self.weight
        return zero_row(self.weight, self.padding_idx)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return small_table_lookup(self.table(), ids)
