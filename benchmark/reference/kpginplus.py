"""KPGINPlus (KP-GNN, Feng et al., NeurIPS 2022: the KP-GIN+ layer with
the attention combine) as plain PyTorch, for the benchmark's check of
what the program computes.  It imports nothing of the program: the
layer equations are written out from the paper and the original code
(KP-GNN's models/GNNs.py, models/KPGIN.py, combine.py), over the
reference's own batches (``RefBatch``: real nodes only, one edge list
per hop), with index gathers and ``index_add_`` where the program runs
its kernels, and a step-by-step LSTM cell where it runs its BiLSTM
kernels.  The parameter names are the program's checkpoint names, so
that one dictionary of seeded weights serves both sides.

One layer l of width H over the window of the last k = min(l + 1, K)
layer outputs h_l, h_{l-1}, ...: hop j (1-based) of the window reads
h_{l+1-j}, adds its path-encoding row (hops >= 2), and sums, over the
hop-j edges s -> r, x_j[s] + E_j[code] into r (E_1 the bond table, E_j
the path-count table, row 0 zero); then exact GELU, plus the gated
peripheral embedding of hop j; the attention combine (a BiLSTM of
hidden size k over the hop axis scores each hop, softmax over hops);
then Linear-BN-ReLU twice.  The backbone adds a BN after each layer,
the residual (the layer's input before the virtual node joined it),
the virtual node (per-graph state broadcast into each layer's input and
updated by a Linear-BN-ReLU x2 MLP from the sum of that input), jumping
knowledge (concat or last), a Linear-ReLU projection, pooling (sum, or
attention with a linear gate) and the linear regressor.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .common import (RefBatch, batch_norm, bilstm_scores, linear, lookup,
                     mlp_bn, segment_sum)

EMB = "embedding_model."


def _lin(spec, name, d_in, d_out, bias=True):
    spec[name + ".weight"] = ((d_out, d_in), ("uniform", d_in ** -0.5))
    if bias:
        spec[name + ".bias"] = ((d_out,), ("uniform", d_in ** -0.5))


def _bn(spec, name, d):
    spec[name + ".weight"] = ((d,), ("around_one", 0.1))
    spec[name + ".bias"] = ((d,), ("uniform", 0.1))
    spec[name + ".running_mean"] = ((d,), ("uniform", 0.1))
    spec[name + ".running_var"] = ((d,), ("around_one", 0.5))


def _mlp(spec, name, d):
    for i in range(2):
        _lin(spec, f"{name}.lin{i}", d, d)
        _bn(spec, f"{name}.bn{i}", d)


def covers(m: dict) -> None:
    """Raise unless the model flags ``m`` are what this reference
    writes out: one regression target per graph, the SPD kernel, the
    attention combine for K > 1, batch norm, no dropout."""
    want = dict(model_name="KPGINPlus", task="graph_regression",
                output_size=1, kernel="spd", norm_type="Batch",
                drop_prob=0.0)
    if m["K"] > 1:
        want["combine"] = "attention"
    off = {k: m.get(k) for k, v in want.items() if m.get(k) != v}
    if off:
        raise NotImplementedError(f"the KPGINPlus reference does not cover "
                                  f"{off}")


def param_spec(m: dict) -> "OrderedDict[str, tuple]":
    """{name: (shape, (rule, scale))} of every tensor the model holds
    (parameters and the norms' running statistics) for the model flags
    ``m`` of a configuration file.  Rules: "uniform" U(-scale, scale),
    "normal-like" U(-sqrt3, sqrt3) (unit variance, for tables),
    "around_one" 1 + U(-scale, scale)."""
    covers(m)
    H, L, K = m["hidden_size"], m["num_layer"], m["K"]
    spec: "OrderedDict[str, tuple]" = OrderedDict()
    table = ("uniform", 3 ** 0.5)
    enc = m["input_encoder"]
    if enc[0] == "embedding":
        spec[EMB + "init_encoder.init_proj.weight"] = ((enc[1], H), table)
    else:
        spec[EMB + "init_encoder.z_embedding.weight"] = ((1000, 8), table)
        _lin(spec, EMB + "init_encoder.init_proj", 8 + 11, H)
    if m["use_rd"]:
        _lin(spec, EMB + "rd_projection", 1, H)
    spec[EMB + "peripheral.pew"] = ((1,), table)
    spec[EMB + "peripheral.pcw"] = ((1,), table)
    pe = EMB + "peripheral.peripheral_edge_embedding"
    spec[pe + ".emb0.weight"] = ((m["num_hop1_edge"] + 2, H), table)
    spec[pe + ".emb1.weight"] = ((m["max_edge_count"] + 1, H), table)
    _lin(spec, pe + ".proj", 2 * H, H)
    pc = EMB + "peripheral.peripheral_configuration_embedding"
    for i in range(m["max_hop_num"] + 1):
        spec[f"{pc}.emb{i}.weight"] = ((m["max_distance_count"] + 1, H),
                                       table)
    _lin(spec, pc + ".proj", (m["max_hop_num"] + 1) * H, H)
    for l in range(L):                                      # noqa: E741
        k = min(l + 1, K)
        g = f"{EMB}gnn{l}"
        spec[g + ".hop1_edge_emb"] = ((m["num_hop1_edge"] + 2, H), table)
        if k > 1:
            spec[g + ".hopk_edge_emb"] = ((m["max_pe_num"] + 2, H), table)
            spec[g + ".hopk_node_path_emb"] = ((m["max_pe_num"], H), table)
            lstm = g + ".combine.attention_lstm.lstm."
            for sfx in ("l0", "l0_reverse"):
                spec[lstm + "weight_ih_" + sfx] = ((4 * k, H),
                                                   ("uniform", k ** -0.5))
                spec[lstm + "weight_hh_" + sfx] = ((4 * k, k),
                                                   ("uniform", k ** -0.5))
                spec[lstm + "bias_ih_" + sfx] = ((4 * k,),
                                                 ("uniform", k ** -0.5))
                spec[lstm + "bias_hh_" + sfx] = ((4 * k,),
                                                 ("uniform", k ** -0.5))
        _mlp(spec, g + ".mlp", H)
        _bn(spec, f"{EMB}norm{l}", H)
    if m["virtual_node"]:
        spec[EMB + "virtualnode.virtualnode_embedding"] = ((1, H),
                                                           ("uniform", 0.1))
        for l in range(L - 1):                              # noqa: E741
            _mlp(spec, f"{EMB}virtualnode.mlp_virtualnode_{l}", H)
    _lin(spec, EMB + "output_proj", H * (L + 1) if m["JK"] == "concat"
         else H, H)
    if m["pooling_method"] == "attention":
        _lin(spec, "pool_gate", H, 1)
    _lin(spec, "regressor", H, 1)
    return spec


def _concat_encoder(P, name, ids, n_cols):
    """proj(concat_c table_c[ids[..., c]]), rows of every table live."""
    parts = [lookup(P[f"{name}.emb{c}.weight"], ids[..., c])
             for c in range(n_cols)]
    return linear(P, name + ".proj", torch.cat(parts, dim=-1))


def forward(P: Dict[str, torch.Tensor], b: RefBatch, m: dict,
            train: bool, stats: Optional[dict] = None) -> torch.Tensor:
    """Predictions (g,) of the batch's graphs; in training, ``stats``
    (when given) receives every batch norm's batch mean and variance."""
    H, L, K = m["hidden_size"], m["num_layer"], m["K"]
    if m["input_encoder"][0] == "embedding":
        x = lookup(P[EMB + "init_encoder.init_proj.weight"], b.x)
    else:
        zemb = lookup(P[EMB + "init_encoder.z_embedding.weight"], b.z)
        x = linear(P, EMB + "init_encoder.init_proj",
                    torch.cat([zemb, b.x], dim=-1))
    if m["use_rd"]:
        x = x + linear(P, EMB + "rd_projection", b.rd)
    pe_name = EMB + "peripheral.peripheral_edge_embedding"
    T = b.per_edge.shape[2]
    per = torch.tanh(P[EMB + "peripheral.pew"]) * sum(
        _concat_encoder(P, pe_name, b.per_edge[:, :, t], 2)
        for t in range(T))
    per = per + torch.tanh(P[EMB + "peripheral.pcw"]) * _concat_encoder(
        P, EMB + "peripheral.peripheral_configuration_embedding",
        b.per_config, m["max_hop_num"] + 1)               # (n, K, H)
    vn = None
    if m["virtual_node"]:
        vn = P[EMB + "virtualnode.virtualnode_embedding"].expand(b.g, H)
    hs = [x]
    for l in range(L):                                      # noqa: E741
        k = min(l + 1, K)
        g = f"{EMB}gnn{l}"
        pre = hs[l]
        if vn is not None:
            hs[l] = pre + vn[b.gid]
        hops = []
        for j in range(k):
            xj = hs[l - j]
            if j > 0:
                xj = xj + lookup(P[g + ".hopk_node_path_emb"],
                                  b.pe[:, j - 1], zero_first=True)
            send, recv, code = b.hops[j]
            table = P[g + (".hop1_edge_emb" if j == 0 else ".hopk_edge_emb")]
            msg = xj[send] + lookup(table, code, zero_first=True)
            agg = segment_sum(msg, recv, b.n)
            hops.append(F.gelu(agg) + per[:, j])
        if k > 1:
            seq = torch.stack(hops)                        # (k, n, H)
            att = torch.softmax(bilstm_scores(
                P, g + ".combine.attention_lstm.lstm.", seq), dim=0)
            h = (seq * att[..., None]).sum(0)
        else:
            h = hops[0]
        h = mlp_bn(P, g + ".mlp", h, train, stats)
        h = batch_norm(P, f"{EMB}norm{l}", h, stats, train)
        if m["residual"]:
            h = h + pre
        hs.append(h)
        if vn is not None and l < L - 1:
            pooled = segment_sum(hs[l], b.gid, b.g)
            out = mlp_bn(P, f"{EMB}virtualnode.mlp_virtualnode_{l}",
                          pooled + vn, train, stats)
            vn = vn + out if m["residual"] else out
    rep = torch.cat(hs, dim=1) if m["JK"] == "concat" else hs[-1]
    rep = F.relu(linear(P, EMB + "output_proj", rep))
    if m["pooling_method"] == "attention":
        s = linear(P, "pool_gate", rep)[:, 0]
        smax = s.new_full((b.g,), -torch.inf).scatter_reduce(
            0, b.gid, s.detach(), reduce="amax")
        ex = torch.exp(s - smax[b.gid])
        den = segment_sum(ex, b.gid, b.g)
        pooled = segment_sum(rep * (ex / den[b.gid])[:, None], b.gid, b.g)
    else:
        pooled = segment_sum(rep, b.gid, b.g)
    return linear(P, "regressor", pooled)[:, 0]
