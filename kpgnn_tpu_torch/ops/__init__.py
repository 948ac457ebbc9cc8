"""Compute primitives (counterpart of kpgnn_tpu/ops): segment ops and
the COO k-hop aggregation, the bidirectional LSTM, and, by module, the
adjacency backends (adjacency.py), the hand-written kernel (spmm.py),
banded (banded.py) and node shards (sharded_adjacency.py)."""
from .lstm import BiLSTM
from .segment import (khop_aggregate, multi_hop_degree, segment_max,
                      segment_mean, segment_softmax, segment_sum)

__all__ = ["segment_sum", "segment_mean", "segment_max", "segment_softmax",
           "khop_aggregate", "multi_hop_degree", "BiLSTM"]
