"""Typed model configuration and the model factory (counterpart of
kpgnn_tpu/models/factory.py).  Every family of ``MODEL_NAMES`` builds:
KPGINPlus on GNNPlus, KPGINPrime on GNNPrime, KPGCN, KPGIN and
KPGraphSAGE on GNN.  The node heads, the QM9 input encoder and bf16
compute are not ported yet and raise."""
from __future__ import annotations

import dataclasses
from typing import Tuple

from torch import nn

from ..nn.encoders import EmbeddingEncoder, LinearEncoder
from ..nn.layers import make_gnn_layer
from .backbones import GNN, GNNPlus, GNNPrime
from .heads import GraphClassification, GraphRegression

MODEL_NAMES = ("KPGCN", "KPGIN", "KPGraphSAGE", "KPGINPlus", "KPGINPrime")
TASKS = ("graph_classification", "graph_regression",
         "node_classification", "node_regression")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # architecture
    model_name: str = "KPGIN"
    hidden_size: int = 48
    num_layer: int = 2
    K: int = 3
    kernel: str = "spd"
    combine: str = "geometric"
    aggr: str = "mean"                  # KPGraphSAGE only
    JK: str = "last"
    norm_type: str = "Batch"
    virtual_node: bool = False
    residual: bool = False
    use_rd: bool = False
    drop_prob: float = 0.0
    compute_dtype: str = "float32"
    eps: float = 0.0
    train_eps: bool = False
    num_l1_layer: int = 1               # KPGINPrime only
    # feature vocabulary sizes (must match the preprocessing config)
    num_hop1_edge: int = 1
    max_pe_num: int = 1
    max_edge_type: int = 1
    max_edge_count: int = 0
    max_hop_num: int = 0
    max_distance_count: int = 0
    # ablations
    wo_peripheral_edge: bool = False
    wo_peripheral_configuration: bool = False
    wo_path_encoding: bool = False
    wo_edge_feature: bool = False
    # input encoding: ("embedding", vocab) | ("linear", in_dim) | ("qm9", _)
    input_encoder: Tuple[str, int] = ("linear", 1)
    # task head
    task: str = "graph_classification"
    pooling_method: str = "sum"
    output_size: int = 1

    def __post_init__(self):
        if self.model_name not in MODEL_NAMES:
            raise ValueError(f"Not supported GNN type {self.model_name!r}")
        if self.task not in TASKS:
            raise ValueError(f"unknown task {self.task!r}")
        if self.model_name in ("KPGCN", "KPGIN", "KPGraphSAGE", "KPGINPrime"):
            if self.hidden_size % self.K:
                raise ValueError(
                    f"hidden_size {self.hidden_size} must divide by K={self.K}")
        if self.model_name == "KPGINPlus" and self.num_layer < self.K:
            raise ValueError("KPGINPlus needs num_layer >= K")


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet "
                               "(ROADMAP.md, Queue 1)")


def _make_encoder(cfg: ModelConfig) -> nn.Module:
    kind, arg = cfg.input_encoder
    if kind == "embedding":
        return EmbeddingEncoder(int(arg), cfg.hidden_size)
    if kind == "linear":
        return LinearEncoder(int(arg), cfg.hidden_size)
    if kind == "qm9":
        raise _not_ported(f"the {kind!r} input encoder")
    raise ValueError(f"unknown input encoder {kind!r}")


def make_model(cfg: ModelConfig) -> nn.Module:
    """Encoder -> KP layers -> backbone -> graph head.  Parameters are
    uninitialized until ``nn.inits.init_parameters(model, seed)``.  As in
    the JAX factory, ``cfg.eps`` reaches no layer: GIN layers start from
    eps 0 (a parameter with ``train_eps``)."""
    if cfg.compute_dtype != "float32":
        raise _not_ported(f"compute_dtype {cfg.compute_dtype!r}")
    layer_fn = make_gnn_layer(
        cfg.model_name, cfg.hidden_size, cfg.K, num_layer=cfg.num_layer,
        num_hop1_edge=cfg.num_hop1_edge, num_pe=cfg.max_pe_num,
        combine=cfg.combine, aggr=cfg.aggr, train_eps=cfg.train_eps)
    common = dict(
        num_layer=cfg.num_layer, hidden_size=cfg.hidden_size, K=cfg.K,
        layer_fn=layer_fn, init_encoder=_make_encoder(cfg),
        num_hop1_edge=cfg.num_hop1_edge, max_edge_count=cfg.max_edge_count,
        max_hop_num=cfg.max_hop_num,
        max_distance_count=cfg.max_distance_count, JK=cfg.JK,
        norm_type=cfg.norm_type, virtual_node=cfg.virtual_node,
        residual=cfg.residual, use_rd=cfg.use_rd,
        wo_peripheral_edge=cfg.wo_peripheral_edge,
        wo_peripheral_configuration=cfg.wo_peripheral_configuration,
        drop_prob=cfg.drop_prob)
    if cfg.model_name == "KPGINPlus":
        backbone = GNNPlus(**common)
    elif cfg.model_name == "KPGINPrime":
        backbone = GNNPrime(num_l1_layer=cfg.num_l1_layer, **common)
    else:
        backbone = GNN(**common)
    if cfg.task == "graph_classification":
        return GraphClassification(backbone, cfg.pooling_method,
                                   cfg.hidden_size, cfg.output_size)
    if cfg.task == "graph_regression":
        return GraphRegression(backbone, cfg.pooling_method,
                               cfg.hidden_size, cfg.output_size)
    raise _not_ported(f"the {cfg.task} head")
