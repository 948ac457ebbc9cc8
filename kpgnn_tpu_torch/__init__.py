"""kpgnn_tpu_torch — the PyTorch/CUDA port of kpgnn_tpu.

Subpackages mirror the JAX package (graph, prep, ops, nn, models, train,
data, scripts, utils), so each module's counterpart is found by name.
The port imports torch, numpy and scipy, never JAX or the JAX package;
the fused k-hop gather/segment-sum runs on a hand-written Hopper kernel
(csrc/gather_segment_sum.cu).  Importing the package builds nothing.
"""
__version__ = "0.1.0"
