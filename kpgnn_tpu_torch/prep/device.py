"""k-hop extraction on the device for batched small graphs (counterpart
of kpgnn_tpu/prep/device.py).

The host path (prep/khop.py and the native prep) computes everything
ahead of training; this module builds the SPD/GD hop codes on the
tensors' device instead: walk-count matrix powers as batched matmuls,
SPD masking and the attr encoding over (B, n, n) adjacency stacks,
giving the dense backend's ``DenseAdj`` directly, from raw adjacency to
model-ready codes without a host round trip.  The peripheral-subgraph
statistics are per-node induced-subgraph computations and stay on the
host path; use this for configurations that do not need them.

Numerics: walk counts are carried in f32 and saturated at CLIP between
steps: a count matters only up to ``max_edge_attr_num`` (clipped anyway)
and as a >0 mask, so saturating early keeps every observable value exact
while avoiding overflow at large K.  That holds only for full-f32
matmuls: on the card call it with TF32 off (``scripts.common
.set_full_f32``, which every entry point runs).

Reference semantics: data_utils.py:55-96 (adjacency powers with zeroed
diagonals, SPD masking, clip+shift attr encoding).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..ops.adjacency import DenseAdj

CLIP = 1_000_000.0    # walk-count saturation (far above any attr clip)


def device_khop_dense(
    adj: torch.Tensor,        # (B, n, n) 0/1 adjacency, [b, i, j]: i -> j
    attr_adj: torch.Tensor,   # (B, n, n) int 1-hop attr codes, receiver-major
    K: int,
    max_edge_attr_num: int,
    kernel: str = "spd",
    v1: int = 4,
    vk: int = 4,
) -> Tuple[DenseAdj, Optional[torch.Tensor]]:
    """(DenseAdj, pe_attr (B*n, K-1) int32 | None) of the batch, on
    ``adj``'s device."""
    if kernel not in ("spd", "gd"):
        raise ValueError(f"unknown kernel {kernel!r}")
    B, n, _ = adj.shape
    a = adj.float()
    eye = torch.eye(n, dtype=torch.bool, device=a.device)[None]

    # walk-count chain, saturated each step; diagonals zeroed per hop
    powers = []
    cur = a
    for k in range(K):
        if k > 0:
            cur = torch.clamp(torch.bmm(cur, a), max=CLIP)
        powers.append(torch.where(eye, 0.0, cur))
    pw = torch.stack(powers, dim=1)                        # (B, K, n, n)

    if kernel == "spd":
        masked = [pw[:, 0]]
        seen = pw[:, 0] > 0
        for k in range(1, K):
            m = torch.where(seen, 0.0, pw[:, k])
            seen = seen | (m > 0)
            masked.append(m)
        hop = torch.stack(masked, dim=1)
    else:
        hop = pw

    # attr encoding: clip, then +1 on nonzeros (0 stays the mask value)
    clipped = torch.clamp(hop, max=float(max_edge_attr_num))
    proc = torch.where(clipped > 0, clipped + 1.0, 0.0).int()

    # the hop-1 column carries the original attr codes where a direct
    # edge exists; the whole stack then turns receiver-major, as the JAX
    # function does (the same codes for a symmetric adjacency and attrs)
    hop1 = torch.where(hop[:, 0] > 0, attr_adj.int(), 0)
    hop_attr = torch.cat([hop1[:, None], proc[:, 1:]], dim=1)
    hop_attr = hop_attr.transpose(-1, -2)                  # receiver-major

    # path encoding: the diagonals of the processed hop matrices, zero
    # by the reference's diagonal zeroing; kept for the layout
    pe = (torch.zeros((B * n, K - 1), dtype=torch.int32, device=a.device)
          if K > 1 else None)
    return DenseAdj.from_codes(hop_attr.contiguous(), v1, vk), pe
