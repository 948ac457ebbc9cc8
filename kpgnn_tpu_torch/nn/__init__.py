"""Layers: KP convolutions, combines, encoders, norms (counterpart of
kpgnn_tpu/nn).

JAX-only, not exported: ``torch_linear_kernel_init``,
``torch_linear_bias_init``, ``kaiming_uniform`` and ``normal_init`` are
flax initializer factories.  Here every parameter-owning module has
``init_params(generator)``, built on ``nn/inits.py``'s
``kaiming_uniform_``, ``uniform_``, ``normal_`` and ``fan_in_bound``,
and ``init_parameters(model, seed)`` calls them."""
from .basic import MLP, TorchLinear
from .combine import AttentionCombine, GeometricCombine, make_combine
from .embed import PaddedEmbed
from .encoders import (EmbeddingEncoder, FeatureConcatEncoder,
                       FeatureSumEncoder, LinearEncoder, QM9InputEncoder)
from .layers import (GINEConv, KPGCNConv, KPGINConv, KPGINPlusConv,
                     KPGraphSAGEConv, make_gnn_layer)
from .norms import (GraphSizeNorm, MaskedBatchNorm, MaskedGraphLayerNorm,
                    MaskedInstanceNorm, PairNorm, make_norm)

__all__ = [
    "PaddedEmbed", "TorchLinear", "MLP",
    "AttentionCombine", "GeometricCombine", "make_combine",
    "FeatureSumEncoder", "FeatureConcatEncoder", "EmbeddingEncoder",
    "LinearEncoder", "QM9InputEncoder",
    "MaskedBatchNorm", "MaskedGraphLayerNorm", "MaskedInstanceNorm",
    "GraphSizeNorm", "PairNorm", "make_norm",
    "KPGINConv", "KPGCNConv", "KPGraphSAGEConv", "KPGINPlusConv", "GINEConv",
    "make_gnn_layer",
]
