"""Model FLOPs of KPGINPlus on a batch's real nodes and edges.

Counted: every dense product as 2 x its multiply-adds, in the form the
architecture defines it (the peripheral embeddings as concat-then-
project, the LSTM's input and recurrent products), and the k-hop
aggregation's two adds per live edge and channel (the edge embedding,
then the sum).  Not counted: elementwise activations, norms, softmaxes
and lookups.  Padding slots count nothing.
"""
from __future__ import annotations

from typing import Sequence


def forward_flops(m: dict, n: int, g: int, edges: Sequence[int]) -> float:
    """One forward over ``n`` real nodes in ``g`` graphs with ``edges[j]``
    live edges at hop j + 1."""
    H, L, K = m["hidden_size"], m["num_layer"], m["K"]
    f = 0.0
    if m["input_encoder"][0] != "embedding":
        f += 2 * n * 19 * H
    if m["use_rd"]:
        f += 2 * n * H
    f += 2 * n * K * m["max_edge_type"] * 2 * H * H        # peripheral edge
    f += 2 * n * K * (m["max_hop_num"] + 1) * H * H        # configuration
    for l in range(L):                                     # noqa: E741
        k = min(l + 1, K)
        f += sum(2 * edges[j] * H for j in range(k))
        if k > 1:
            f += 2 * 2 * (k * n) * H * 4 * k               # input products
            f += 2 * 2 * k * n * 4 * k * k                 # recurrence
        f += 2 * 2 * n * H * H                             # the MLP
        if m["virtual_node"] and l < L - 1:
            f += 2 * 2 * g * H * H
    f += 2 * n * H * H * ((L + 1) if m["JK"] == "concat" else 1)
    if m["pooling_method"] == "attention":
        f += 2 * n * H
    f += 2 * g * H
    return f
