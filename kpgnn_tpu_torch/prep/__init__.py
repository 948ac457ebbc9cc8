"""Offline k-hop neighbourhood extraction (counterpart of
kpgnn_tpu/prep)."""
from .khop import (KHopConfig, adjacency_powers, apply_ablation_clamps,
                   bfs_apsp, extract_khop, resistance_distance)
from .runner import preprocess_graphs

__all__ = ["KHopConfig", "extract_khop", "adjacency_powers", "bfs_apsp",
           "resistance_distance", "apply_ablation_clamps",
           "preprocess_graphs"]
