"""Cross-hop combine functions (counterpart of kpgnn_tpu/nn/combine.py).

Both reduce the hop axis of (N, K, D) states, or of (K, N, D) with
``hop_major=True``.  The layout is an argument of each call: a KP layer
learns which layout its backend gives it only when it is called, and
the parameters do not depend on it.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.lstm import BiLSTM


class AttentionCombine(nn.Module):
    """Bi-LSTM over the hop axis scores each hop; softmax-weighted sum.
    The LSTM hidden size is K, so scores are (.., 2K) summed."""

    def __init__(self, K: int, input_size: int):
        super().__init__()
        self.attention_lstm = BiLSTM(input_size, K)

    def forward(self, x: torch.Tensor, hop_major: bool) -> torch.Tensor:
        score = self.attention_lstm(x, time_major=hop_major)
        hop_axis = 0 if hop_major else 1
        att = torch.softmax(score.sum(-1), dim=hop_axis)[..., None]
        return (x * att).sum(dim=hop_axis)


class GeometricCombine(nn.Module):
    """Per-channel geometric hop weights theta_i ∝ sigmoid(a) *
    (1 - sigmoid(a))^i, softmax-normalized over hops."""

    def __init__(self, K: int, hidden_size: int):
        super().__init__()
        self.K = K
        self.alphas = nn.Parameter(torch.zeros(hidden_size))

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.alphas.zero_()

    def forward(self, x: torch.Tensor, hop_major: bool) -> torch.Tensor:
        a = torch.sigmoid(self.alphas).to(x.dtype)
        i = torch.arange(self.K, dtype=x.dtype, device=x.device)[:, None]
        thetas = torch.softmax(a[None, :] * (1.0 - a[None, :]) ** i, dim=0)
        if hop_major:
            return (x * thetas[:, None]).sum(dim=0)
        return (x * thetas[None]).sum(dim=-2)


def make_combine(combine: str, K: int, hidden_size: int) -> nn.Module:
    if combine == "attention":
        return AttentionCombine(K, hidden_size)
    if combine == "geometric":
        return GeometricCombine(K, hidden_size)
    raise ValueError("Not implemented combine function")
