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
    """One-layer bidirectional LSTM: (B, T, F) -> (B, T, 2H); a call
    with ``time_major=True`` takes (T, B, F) -> (T, B, 2H)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.lstm = nn.LSTM(input_size, hidden_size, num_layers=1,
                            bidirectional=True)

    def init_params(self, generator: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        with torch.no_grad():
            for p in self.lstm.parameters():
                p.copy_(torch.empty_like(p).uniform_(
                    -bound, bound, generator=generator))

    def forward(self, x: torch.Tensor,
                time_major: bool = False) -> torch.Tensor:
        if time_major:
            return self.lstm(x)[0]
        return self.lstm(x.transpose(0, 1))[0].transpose(0, 1)
