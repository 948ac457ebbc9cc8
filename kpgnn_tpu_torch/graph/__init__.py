"""Padded graph batches and their collation (counterpart of
kpgnn_tpu/graph)."""
from .batch import (BucketSpec, GraphBatch, collate, collate_banded,
                    collate_dense, collate_pallas, pad_sizes)
from .data import Graph

__all__ = ["Graph", "GraphBatch", "collate", "collate_banded",
           "collate_dense", "collate_pallas", "pad_sizes", "BucketSpec"]
