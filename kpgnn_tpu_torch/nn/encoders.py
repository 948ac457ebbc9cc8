"""Feature and input encoders (counterpart of kpgnn_tpu/nn/encoders.py)."""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .basic import TorchLinear
from .embed import PaddedEmbed


class FeatureConcatEncoder(nn.Module):
    """Per-column embeddings, concatenated then projected — the peripheral
    edge / configuration embeddings.

    Computed in the folded form of the JAX module: proj(concat_i(T_i[x_i]))
    = sum_i one_hot(x_i) @ (T_i @ P_i) + bias, where P_i is the i-th H-row
    slice of the projection (stored (out, in) here, so P_i^T).  An id
    outside [0, dim_i) reads a zero row.  ``sum_axis`` (an axis of x
    without its last dim) also folds ``encoder(x).sum(axis=sum_axis)``
    into the histogram, with the bias scaled by the summed length.
    ``padding=False`` keeps row 0 of every table live.
    """

    def __init__(self, feature_dims: Sequence[int], hidden_size: int,
                 padding: bool = False):
        super().__init__()
        self.dims = list(feature_dims)
        self.hidden_size = hidden_size
        self.padding = padding
        for i, dim in enumerate(self.dims):
            self.add_module(f"emb{i}", PaddedEmbed(
                dim, hidden_size, padding_idx=0 if padding else None))
        self.proj = TorchLinear(len(self.dims) * hidden_size, hidden_size)

    def forward(self, x: torch.Tensor,
                sum_axis: Optional[int] = None) -> torch.Tensor:
        H = self.hidden_size
        if sum_axis is not None and sum_axis < 0:
            sum_axis += x.dim() - 1
        w = self.proj.weight                              # (H, C*H)
        table = torch.cat(
            [getattr(self, f"emb{i}").table() @ w[:, i * H:(i + 1) * H].t()
             for i in range(len(self.dims))], dim=0)      # (sum dims, H)
        oh = torch.cat(
            [(x[..., i:i + 1] == torch.arange(dim, device=x.device)
              ).to(torch.float32)
             for i, dim in enumerate(self.dims)], dim=-1)  # (..., V)
        if sum_axis is not None:
            oh = oh.sum(dim=sum_axis)
        out = oh @ table
        n_bias = 1 if sum_axis is None else x.shape[sum_axis]
        return out + n_bias * self.proj.bias.to(out.dtype)


class EmbeddingEncoder(nn.Module):
    """Initial node encoder for integer features (no padding row)."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.init_proj = PaddedEmbed(input_size, hidden_size,
                                     padding_idx=None)

    def forward(self, batch) -> torch.Tensor:
        x = batch.x
        if x.dim() == 2 and x.shape[-1] == 1:
            x = x[:, 0]
        return self.init_proj(x)


class LinearEncoder(nn.Module):
    """Initial node encoder for float features: one torch-initialized
    linear map of ``batch.x`` as f32."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.init_proj = TorchLinear(input_size, hidden_size)

    def forward(self, batch) -> torch.Tensor:
        return self.init_proj(batch.x.float())


QM9_NODE_FEATURES = 11          # one-hot type H/C/N/O/F + 6 atom scalars


class QM9InputEncoder(nn.Module):
    """An 8-wide z embedding over 1000 rows (summed over the codes of a
    multi-code z), concatenated with x (and pos under ``use_pos``), then
    ``init_proj``.  The 1000-row table goes through ``F.embedding``
    (``PaddedEmbed``): every QM9 node reads one of five ids, where an
    indexing gather's backward would serialise."""

    def __init__(self, hidden_size: int, use_pos: bool = False):
        super().__init__()
        self.use_pos = use_pos
        self.z_embedding = PaddedEmbed(1000, 8, padding_idx=None)
        self.init_proj = TorchLinear(
            8 + QM9_NODE_FEATURES + (3 if use_pos else 0), hidden_size)

    def forward(self, batch) -> torch.Tensor:
        z_emb = self.z_embedding(batch.z)
        if z_emb.dim() == 3:
            z_emb = z_emb.sum(dim=1)
        parts = [z_emb, batch.x.float()]
        if self.use_pos:
            parts.append(batch.pos.float())
        return self.init_proj(torch.cat(parts, dim=-1))
