"""kpgnn_tpu_torch — the PyTorch/CUDA port of kpgnn_tpu.

Subpackages mirror the JAX package (graph, prep, ops, nn, models, train,
data, parallel, scripts, utils), so each module's counterpart is found
by name, and each subpackage exports the names its twin exports.  The
port imports torch, numpy and scipy, never JAX or the JAX package; the
fused k-hop gather/segment-sum runs on a hand-written Hopper kernel
(csrc/gather_segment_sum.cu).  Importing the package builds nothing.

    import kpgnn_tpu_torch as kt
    khop = kt.KHopConfig(K=4)
    graphs = [kt.extract_khop(n, edge_index, None, khop, x=x, y=y)
              for n, edge_index, x, y in raw]
    cfg = kt.ModelConfig(K=4, hidden_size=48, output_size=2)
    loader = kt.GraphLoader(graphs, 64, shuffle=True, mode="pallas",
                            v1=cfg.num_hop1_edge + 2, vk=cfg.max_pe_num + 2)
    trainer = kt.Trainer(kt.make_model(cfg), kt.TrainConfig(num_epochs=10),
                         loss="cross_entropy")
    model, results = trainer.fit(loader)      # on the card; device="cpu"
"""
__version__ = "0.1.0"

from .graph import Graph, GraphBatch, collate, collate_dense  # noqa: E402
from .models import ModelConfig, make_model                   # noqa: E402
from .prep import KHopConfig, extract_khop                    # noqa: E402
from .train import GraphLoader, TrainConfig, Trainer          # noqa: E402

__all__ = ["Graph", "GraphBatch", "collate", "collate_dense", "ModelConfig",
           "make_model", "KHopConfig", "extract_khop", "GraphLoader",
           "TrainConfig", "Trainer"]
