"""Host-side graph container (counterpart of kpgnn_tpu/graph/data.py).

A `Graph` is a plain numpy record of one preprocessed graph.  It is the
output of `kpgnn_tpu_torch.prep.extract_khop` and the input of
`kpgnn_tpu_torch.graph.batch.collate`.

Feature-value contract (mirrors the reference semantics,
reference: data_utils.py:49-50,85-87):
  edge_attr value 0  -> masked / hop-absent
  edge_attr value 1  -> self-loop (injected by the GCN layer only)
  edge_attr value >=2 -> real feature
Embedding tables downstream are sized `num_values + 2` with index 0 mapping
to the zero vector.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class Graph:
    """One graph, numpy, host memory.

    Attributes:
      num_nodes: N
      edge_index: (2, E) int32 — row 0 senders, row 1 receivers; messages
        flow sender -> receiver (out[i] sums edges with receiver == i).
      edge_attr: (E, K) int32 — column 0 is the 1-hop edge type, columns
        1..K-1 are the hop-k path/walk encodings (see prep).
      x: (N, F) node features; int for embedding datasets, float otherwise.
      y: graph- or node-level target.
      pe_attr: (N, K-1) int32 path encoding per node, or None when K == 1.
      peripheral_edge_attr: (N, K, T, 2) int32 or None.
      peripheral_config_attr: (N, K, H+1) int32 or None.
      rd: (N, 1) float resistance distance, or None.
      z: (N,) or (N, Z) int atom codes (QM9), or None.
      pos: (N, 3) float coordinates, or None.
    """

    num_nodes: int
    edge_index: np.ndarray
    edge_attr: np.ndarray
    x: Optional[np.ndarray] = None
    y: Optional[np.ndarray] = None
    pe_attr: Optional[np.ndarray] = None
    peripheral_edge_attr: Optional[np.ndarray] = None
    peripheral_config_attr: Optional[np.ndarray] = None
    rd: Optional[np.ndarray] = None
    z: Optional[np.ndarray] = None
    pos: Optional[np.ndarray] = None
    meta: Optional[dict] = None

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def K(self) -> int:
        return int(self.edge_attr.shape[1]) if self.edge_attr.ndim == 2 else 1

    def replace(self, **kw: Any) -> "Graph":
        return dataclasses.replace(self, **kw)
