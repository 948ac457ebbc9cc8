"""GNN backbones (counterpart of kpgnn_tpu/models/backbones.py).

Three families:
  * ``GNN``      — a stack of identical KP layers (hidden split across
                   hops);
  * ``GNNPlus``  — KP-GIN+ layers whose hop axis is the window of the
                   last k = min(l + 1, K) layer outputs;
  * ``GNNPrime`` — num_l1_layer K-hop layers, then plain 1-hop GINE
                   layers.
Shared machinery: the peripheral embeddings (computed once per forward),
the virtual node, jumping knowledge and the masked norms.  Every update
is written out of place so autograd sees each intermediate.

``compute_dtype`` is the activations' dtype: the encoded nodes are cast
to it once, after ``rd_projection`` (the JAX backbones' ``x.astype``),
and everything downstream follows x's dtype while the parameters, the
norms' statistics, the virtual-node state and the loss stay f32.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..graph.batch import GraphBatch
from ..nn.basic import MLP, TorchLinear
from ..nn.encoders import FeatureConcatEncoder
from ..nn.inits import normal_
from ..nn.layers import GINEConv
from ..nn.norms import (MaskedBatchNorm, MaskedGraphLayerNorm, PairNorm,
                        make_norm)
from ..ops.adjacency import hop_major_native
from ..ops.lstm import BiLSTM
from ..ops.segment import segment_sum
from ..ops.sharded_adjacency import node_axis, preduce
from ..utils.profiling import span


def _dropout(x: torch.Tensor, rate: float, train: bool,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout drawing its mask from an explicit generator (on
    x's device).  Its bits differ from JAX's, so parity runs use
    rate 0."""
    if not train or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < (1.0 - rate)
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _make_norm(norm_type: str, features: int) -> nn.Module:
    cls = make_norm(norm_type)
    if cls in (MaskedBatchNorm, MaskedGraphLayerNorm):
        return cls(features)
    return cls()


def _apply_norm(norm: nn.Module, x: torch.Tensor, batch: GraphBatch,
                train: bool) -> torch.Tensor:
    """One per-layer norm with its masking inputs (the JAX package's
    switch, kpgnn_tpu/models/backbones.py:52-76); on a node shard its
    statistics complete over the node group."""
    group = node_axis(batch)
    if isinstance(norm, MaskedBatchNorm):
        return norm(x, mask=batch.node_mask, use_running_average=not train,
                    group=group)
    if isinstance(norm, PairNorm):
        return norm(x, mask=batch.node_mask, group=group)
    return norm(x, batch.node_graph_ids, batch.g_pad, mask=batch.node_mask,
                group=group, indptr=batch.graph_indptr)


class _PeripheralEmbed(nn.Module):
    """Peripheral edge + configuration embeddings, computed once per
    forward and fed to every layer; ``gate`` is sigmoid (GNN / GNNPrime)
    or tanh (GNNPlus).  The encoders keep row 0 live (the reference's
    falsy ``padding=0``)."""

    def __init__(self, width: int, num_hop1_edge: int, max_edge_count: int,
                 max_hop_num: int, max_distance_count: int,
                 wo_peripheral_edge: bool, wo_peripheral_configuration: bool,
                 gate: str = "sigmoid"):
        super().__init__()
        self.width = width
        self.gate = torch.sigmoid if gate == "sigmoid" else torch.tanh
        self.use_edge = not wo_peripheral_edge
        self.use_config = not wo_peripheral_configuration
        if self.use_edge:
            self.peripheral_edge_embedding = FeatureConcatEncoder(
                [num_hop1_edge + 2, max_edge_count + 1], width,
                padding=False)
            self.pew = nn.Parameter(torch.empty(1))
        if self.use_config:
            self.peripheral_configuration_embedding = FeatureConcatEncoder(
                [max_distance_count + 1] * (max_hop_num + 1), width,
                padding=False)
            self.pcw = nn.Parameter(torch.empty(1))

    def init_params(self, generator: torch.Generator) -> None:
        if self.use_edge:
            normal_(self.pew, generator)
        if self.use_config:
            normal_(self.pcw, generator)

    def forward(self, batch: GraphBatch, K: int) -> torch.Tensor:
        out = torch.zeros((batch.n_pad, K, self.width),
                          device=batch.node_mask.device)
        if self.use_edge and batch.peripheral_edge_attr is not None:
            emb = self.peripheral_edge_embedding(
                batch.peripheral_edge_attr, sum_axis=-1)     # (N, K, W)
            out = out + self.gate(self.pew) * emb
        if self.use_config and batch.peripheral_config_attr is not None:
            out = out + self.gate(self.pcw) * \
                self.peripheral_configuration_embedding(
                    batch.peripheral_config_attr)
        return out


class _VirtualNode(nn.Module):
    """Virtual-node state (zero-initialized) and its per-layer
    Linear-BN-ReLU x2 update, BN masked over real graphs."""

    def __init__(self, hidden_size: int, num_layer: int):
        super().__init__()
        self.virtualnode_embedding = nn.Parameter(
            torch.zeros(1, hidden_size))
        for i in range(num_layer - 1):
            self.add_module(f"mlp_virtualnode_{i}", MLP(
                hidden_size, [hidden_size, hidden_size], use_batchnorm=True))

    def init_params(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.virtualnode_embedding.zero_()

    def initial(self, num_graphs: int) -> torch.Tensor:
        return self.virtualnode_embedding.expand(num_graphs, -1)

    @staticmethod
    def broadcast(vn: torch.Tensor, batch: GraphBatch, dtype) -> torch.Tensor:
        """Each node's row of the per-graph state ``vn``, in ``dtype``.
        ``F.embedding``, not ``vn[ids]``: every padding node reads the pad
        graph's row, and the indexing gather's backward serialises on
        that one id on the card (10.1 of ~32 device ms per QM9 step,
        PERF.md §5); the embedding backward sums repeated ids in
        parallel."""
        return F.embedding(batch.node_graph_ids.long(), vn).to(dtype)

    def update(self, layer: int, h_prev, vn, batch: GraphBatch, train: bool,
               residual: bool, drop_prob: float, generator) -> torch.Tensor:
        pooled = preduce(segment_sum(
            h_prev * batch.node_mask[:, None].to(h_prev.dtype),
            batch.node_graph_ids, batch.g_pad,
            indptr=batch.graph_indptr).float(), node_axis(batch))
        out = getattr(self, f"mlp_virtualnode_{layer}")(
            pooled + vn, mask=batch.graph_mask, train=train)
        out = _dropout(out, drop_prob, train, generator)
        return vn + out if residual else out


def _jumping_knowledge(JK: str, h_list: List[torch.Tensor],
                       attention_lstm: Optional[nn.Module]) -> torch.Tensor:
    if JK == "concat":
        return torch.cat(h_list, dim=1)
    if JK == "last":
        return h_list[-1]
    if JK == "max":
        return torch.stack(h_list, dim=0).max(dim=0).values
    if JK == "sum":
        return torch.stack(h_list, dim=0).sum(dim=0)
    if JK == "attention":
        hs = torch.stack(h_list, dim=1)                     # (N, L+1, H)
        score = attention_lstm(hs)
        att = torch.softmax(score.sum(-1), dim=1)[..., None]
        return (hs * att).sum(dim=1)
    raise ValueError(f"unknown JK {JK!r}")


class _Backbone(nn.Module):
    """What the three backbones share: the encoder (plus
    ``rd_projection``), the gated peripheral embedding, the virtual node,
    a norm after each layer, jumping knowledge and the output projection.
    ``layers`` are (name, module) pairs, each registered before its
    norm."""

    def __init__(self, num_layer: int, hidden_size: int, K: int,
                 init_encoder: nn.Module,
                 layers: Sequence[Tuple[str, nn.Module]],
                 peripheral_width: int, gate: str, num_hop1_edge: int = 1,
                 max_edge_count: int = 0, max_hop_num: int = 0,
                 max_distance_count: int = 0, JK: str = "last",
                 norm_type: str = "Batch", virtual_node: bool = True,
                 residual: bool = False, use_rd: bool = False,
                 wo_peripheral_edge: bool = False,
                 wo_peripheral_configuration: bool = False,
                 drop_prob: float = 0.1,
                 compute_dtype: str = "float32"):
        super().__init__()
        H, L = hidden_size, num_layer
        self.H, self.K, self.L = H, K, L
        self.JK, self.residual, self.use_rd = JK, residual, use_rd
        self.drop_prob = drop_prob
        self.compute_dtype = getattr(torch, compute_dtype)
        self.init_encoder = init_encoder
        if use_rd:
            self.rd_projection = TorchLinear(1, H)
        self.peripheral = _PeripheralEmbed(
            peripheral_width, num_hop1_edge, max_edge_count, max_hop_num,
            max_distance_count, wo_peripheral_edge,
            wo_peripheral_configuration, gate=gate)
        self.virtualnode = _VirtualNode(H, L) if virtual_node else None
        for l, (name, layer) in enumerate(layers):          # noqa: E741
            self.add_module(name, layer)
            self.add_module(f"norm{l}", _make_norm(norm_type, H))
        if JK == "attention":
            self.attention_lstm = BiLSTM(H, L)
        self.output_proj = TorchLinear(H * (L + 1) if JK == "concat" else H,
                                       H)

    def _inputs(self, batch: GraphBatch, hop_major: bool):
        """(x, peripheral, vn): the encoded nodes in the compute dtype,
        the peripheral embedding in the same dtype ((K, N, W) with
        ``hop_major``: one transpose per forward) and the initial
        virtual-node state (or None)."""
        with span("model.encode"):
            x = self.init_encoder(batch)
            if x.dim() == 3 and x.shape[1] == 1:
                x = x[:, 0]
            if self.use_rd and batch.rd is not None:
                x = x + self.rd_projection(batch.rd)
            x = x.to(self.compute_dtype)
            peripheral = self.peripheral(batch, self.K).to(x.dtype)
            if hop_major:
                peripheral = peripheral.transpose(0, 1)
            vn = (self.virtualnode.initial(batch.g_pad)
                  if self.virtualnode is not None else None)
        return x, peripheral, vn

    def _layers(self, batch, h_list, vn, layer_call, layers, train,
                generator, always_drop: bool, residual_pre_vn: bool = False):
        """Run ``layer_call(l, h)`` for l in ``layers``, each followed by
        its norm, dropout (every layer with ``always_drop``, else all but
        the last), the residual and the virtual-node update; returns the
        virtual-node state.  The residual adds the layer's input, or with
        ``residual_pre_vn`` that input before the virtual node joined it
        (GNNPlus's ``last_h``)."""
        L, vn_mod = self.L, self.virtualnode
        for l in layers:                                    # noqa: E741
            with span("model.layer"):
                pre = h_list[l]
                if vn_mod is not None:
                    h_list[l] = pre + vn_mod.broadcast(vn, batch, pre.dtype)
                h = layer_call(l, h_list[l])
                h = _apply_norm(getattr(self, f"norm{l}"), h, batch, train)
                if always_drop or l != L - 1:
                    h = _dropout(h, self.drop_prob, train, generator)
                if self.residual:
                    h = h + (pre if residual_pre_vn else h_list[l])
                h_list.append(h)
                if vn_mod is not None and l < L - 1:
                    vn = vn_mod.update(l, h_list[l], vn, batch, train,
                                       self.residual, self.drop_prob,
                                       generator)
        return vn

    def _readout(self, h_list, train, generator) -> torch.Tensor:
        with span("model.readout"):
            rep = _jumping_knowledge(self.JK, h_list,
                                     getattr(self, "attention_lstm", None))
            rep = self.output_proj(rep)
            return _dropout(F.relu(rep), self.drop_prob, train, generator)


class GNNPlus(_Backbone):
    """KP-GIN+ framework: layer l's hop axis is the window of the last
    k = min(l + 1, K) layer outputs; the peripheral embedding is full
    width, behind a tanh gate."""

    def __init__(self, num_layer: int, hidden_size: int, K: int,
                 layer_fn: Callable[[int], nn.Module],
                 init_encoder: nn.Module, **kw):
        if num_layer < K:
            raise ValueError("GNNPlus needs num_layer >= K")
        super().__init__(num_layer, hidden_size, K, init_encoder,
                         [(f"gnn{l}", layer_fn(l))
                          for l in range(num_layer)],       # noqa: E741
                         hidden_size, "tanh", **kw)

    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, peripheral_hm, vn = self._inputs(batch, hop_major=True)
        h_list = [x]

        def layer_call(l, h):                               # noqa: E741
            k = min(l + 1, self.K)
            window = torch.stack([h_list[j] for j in range(l, l - k, -1)],
                                 dim=0)                     # (k, N, H)
            return getattr(self, f"gnn{l}")(
                window, batch.adj.slice_hops(k),
                batch.pe_attr[:, :k - 1] if batch.pe_attr is not None
                else None,
                peripheral_hm[:k], node_mask=batch.node_mask, train=train)

        self._layers(batch, h_list, vn, layer_call, range(self.L), train,
                     generator, always_drop=False, residual_pre_vn=True)
        return self._readout(h_list, train, generator)


class GNN(_Backbone):
    """A stack of ``num_layer`` identical KP layers; the peripheral
    embedding has the layers' hop width d_k = H / K, or H with
    ``peripheral_full_width`` (GNNPlus's width), behind a sigmoid
    gate."""

    def __init__(self, num_layer: int, hidden_size: int, K: int,
                 layer_fn: Callable[[int], nn.Module],
                 init_encoder: nn.Module,
                 peripheral_full_width: bool = False, **kw):
        super().__init__(num_layer, hidden_size, K, init_encoder,
                         [(f"gnn{l}", layer_fn(l))
                          for l in range(num_layer)],       # noqa: E741
                         hidden_size if peripheral_full_width
                         else hidden_size // K, "sigmoid", **kw)

    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, peripheral, vn = self._inputs(batch, hop_major_native(batch.adj))
        h_list = [x]
        self._layers(batch, h_list, vn, lambda l, h: getattr(
            self, f"gnn{l}")(h, batch.adj, batch.pe_attr, peripheral,
                             node_mask=batch.node_mask, train=train),
            range(self.L), train, generator, always_drop=False)
        return self._readout(h_list, train, generator)


class GNNPrime(_Backbone):
    """``num_l1_layer`` K-hop layers, then 1-hop GINE layers, with GNN's
    peripheral embedding.  Dropout follows every K-hop layer, the last
    included (the reference's l1 loop drops unconditionally)."""

    def __init__(self, num_layer: int, hidden_size: int, K: int,
                 layer_fn: Callable[[int], nn.Module],
                 init_encoder: nn.Module, num_l1_layer: int = 1, **kw):
        if num_l1_layer < 1 or num_layer < 2:
            raise ValueError("GNNPrime needs num_l1_layer >= 1 and "
                             "num_layer >= 2")
        layers = ([(f"khop_gnn{l}", layer_fn(l))
                   for l in range(num_l1_layer)]            # noqa: E741
                  + [(f"gine{l}", GINEConv(hidden_size,
                                           kw.get("num_hop1_edge", 1)))
                     for l in range(num_layer - num_l1_layer)])  # noqa: E741
        super().__init__(num_layer, hidden_size, K, init_encoder, layers,
                         hidden_size // K, "sigmoid", **kw)
        self.L1 = num_l1_layer

    def forward(self, batch: GraphBatch, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x, peripheral, vn = self._inputs(batch, hop_major_native(batch.adj))
        h_list = [x]
        vn = self._layers(batch, h_list, vn, lambda l, h: getattr(
            self, f"khop_gnn{l}")(h, batch.adj, batch.pe_attr, peripheral,
                                  node_mask=batch.node_mask, train=train),
            range(self.L1), train, generator, always_drop=True)
        self._layers(batch, h_list, vn, lambda l, h: getattr(
            self, f"gine{l - self.L1}")(h, batch.adj,
                                        node_mask=batch.node_mask,
                                        train=train),
            range(self.L1, self.L), train, generator, always_drop=False)
        return self._readout(h_list, train, generator)
