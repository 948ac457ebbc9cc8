"""Backbones, task heads and the model factory (counterpart of
kpgnn_tpu/models)."""
from .backbones import GNN, GNNPlus, GNNPrime
from .factory import ModelConfig, make_model
from .heads import (GraphClassification, GraphRegression,
                    NodeClassification, NodeRegression)

__all__ = [
    "GNN", "GNNPlus", "GNNPrime",
    "GraphClassification", "GraphRegression",
    "NodeClassification", "NodeRegression",
    "make_model", "ModelConfig",
]
