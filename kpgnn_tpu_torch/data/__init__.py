"""Dataset builders and graph generators (counterpart of
kpgnn_tpu/data)."""
from .counting import TASKS as COUNTING_TASKS
from .counting import generate_counting_dataset
from .expressiveness import (CSL_SKIPS, generate_csl, load_exp_pickle,
                             load_exp_txt, load_sr25)
from .generation import GraphType, adjacency_to_edge_index, generate_graph
from .molecules import QM9_CONVERSION, load_qm9, load_qm9_raw, load_zinc
from .ogb import load_ogb_graphpred
from .property import generate_property_dataset
from .synthetic import synthetic_khop_graphs, synthetic_molecules
from .tu import load_tu_gin_split, load_tu_standard, num_tag_classes

__all__ = [
    "synthetic_molecules", "synthetic_khop_graphs",
    "GraphType", "generate_graph", "adjacency_to_edge_index",
    "generate_property_dataset", "generate_counting_dataset", "COUNTING_TASKS",
    "load_exp_pickle", "load_exp_txt", "load_sr25", "generate_csl", "CSL_SKIPS",
    "load_tu_standard", "load_tu_gin_split", "num_tag_classes",
    "load_zinc", "load_qm9", "load_qm9_raw", "QM9_CONVERSION",
    "load_ogb_graphpred",
]
