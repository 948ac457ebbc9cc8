"""Bidirectional LSTM over a short axis (counterpart of
kpgnn_tpu/ops/lstm.py).

The JAX package writes the recurrence as an unrolled ``lax.scan``; here
it is ``torch.nn.LSTM(bidirectional=True)``, whose gate order (input,
forget, cell, output) and parameter layout are the ones the JAX module
documents.  Parameters initialize U(-1/sqrt(H), 1/sqrt(H)) from an
explicit generator.

Precision: the parameters stay f32.  The recurrence runs in the
input's dtype (bf16 under ``--bf16``), as the JAX module does: the
weights and the zero initial state are cast to it, and the call is the
one ``nn.LSTM.forward`` makes (``torch._VF.lstm``; the cast is a no-op
for an f32 input).  On the card a bf16 input runs cuDNN's bf16 RNN
kernels; chip_smoke.py requires that of the ``--bf16`` step's profile.
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

    def _run(self, x: torch.Tensor) -> torch.Tensor:
        """(T, B, F) -> (T, B, 2H) in x's dtype."""
        weights = [w.to(x.dtype) for ws in self.lstm.all_weights
                   for w in ws]
        h0 = x.new_zeros(2, x.shape[1], self.hidden_size)
        return torch._VF.lstm(x, (h0, h0), weights, True, 1, 0.0,
                              self.training, True, False)[0]

    def forward(self, x: torch.Tensor,
                time_major: bool = False) -> torch.Tensor:
        if time_major:
            return self._run(x)
        return self._run(x.transpose(0, 1)).transpose(0, 1)
