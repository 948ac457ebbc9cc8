"""Bidirectional LSTM over a short axis (counterpart of
kpgnn_tpu/ops/lstm.py).

The JAX package writes the recurrence as an unrolled ``lax.scan``; here
it is ``torch.nn.LSTM(bidirectional=True)``, whose gate order (input,
forget, cell, output) and parameter layout are the ones the JAX module
documents.  Parameters initialize U(-1/sqrt(H), 1/sqrt(H)) from an
explicit generator.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class BiLSTM(nn.Module):
    """One-layer bidirectional LSTM: (B, T, F) -> (B, T, 2H); with
    ``time_major=True`` (T, B, F) -> (T, B, 2H)."""

    def __init__(self, input_size: int, hidden_size: int,
                 time_major: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        self.time_major = time_major
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=1,
                            bidirectional=True, batch_first=not time_major)

    def init_params(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.lstm.parameters():
                p.copy_(torch.empty_like(p).uniform_(
                    -bound, bound, generator=generator))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out, _ = self.lstm(x)
        return out
