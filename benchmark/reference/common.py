"""What every plain reference model shares: its batches of prepped
molecules, the layer pieces written out (lookups, linear maps, batch
norm, index sums, a step-by-step bidirectional LSTM), the loss, and
Adam over a few steps.  It imports nothing of the program."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F


def is_buffer(name: str) -> bool:
    return name.endswith(".running_mean") or name.endswith(".running_var")


@dataclasses.dataclass
class RefBatch:
    """Real nodes of a list of prepped molecules, concatenated."""
    n: int
    g: int
    gid: torch.Tensor                   # (n,) graph of each node
    x: torch.Tensor                     # (n,) codes or (n, F) float
    z: Optional[torch.Tensor]
    rd: Optional[torch.Tensor]          # (n, 1)
    hops: List[tuple]                   # K of (send, recv, code)
    pe: torch.Tensor                    # (n, K-1)
    per_edge: torch.Tensor              # (n, K, T, 2)
    per_config: torch.Tensor            # (n, K, D+1)
    y: torch.Tensor                     # (g,)


def make_batch(mols, preps, device) -> RefBatch:
    """A ``RefBatch`` of raw molecules and their ``prep.Prepped``."""
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a),  # noqa: E731
                                      dtype=dt, device=device)
    off = np.cumsum([0] + [p.n for p in preps])
    K = len(preps[0].hops)
    hops = []
    for k in range(K):
        parts = [p.hops[k] + np.array([[o], [o], [0]])
                 for p, o in zip(preps, off[:-1])]
        e = np.concatenate(parts, axis=1)
        hops.append((t(e[0], torch.long), t(e[1], torch.long),
                     t(e[2], torch.long)))
    x = np.concatenate([m["x"] for m in mols])
    features = "z" in mols[0]
    return RefBatch(
        n=int(off[-1]), g=len(mols),
        gid=t(np.repeat(np.arange(len(mols)), [p.n for p in preps]),
              torch.long),
        x=t(x, torch.float32) if features else t(x.reshape(-1), torch.long),
        z=t(np.concatenate([m["z"] for m in mols]), torch.long)
        if features else None,
        rd=(t(np.concatenate([p.rd for p in preps])[:, None], torch.float32)
            if preps[0].rd is not None else None),
        hops=hops,
        pe=t(np.concatenate([p.pe for p in preps]), torch.long),
        per_edge=t(np.concatenate([p.per_edge for p in preps]), torch.long),
        per_config=t(np.concatenate([p.per_config for p in preps]),
                     torch.long),
        y=t(np.concatenate([np.asarray(m["y"]).reshape(-1)[:1]
                            for m in mols]), torch.float32))


def lookup(table, ids, zero_first=False):
    """table[ids], an id outside the table reading zeros; row 0 reads
    zeros with ``zero_first``."""
    ok = (ids >= 0) & (ids < table.shape[0])
    if zero_first:
        ok = ok & (ids != 0)
    out = table[ids.clamp(0, table.shape[0] - 1)]
    return out * ok[..., None].to(out.dtype)


def linear(P, name, x):
    return x @ P[name + ".weight"].t() + P[name + ".bias"]


def batch_norm(P, name, x, stats, train):
    """BatchNorm over the rows of x (all of them real), biased variance
    in training (kept in ``stats`` when given), the running estimates
    otherwise; eps 1e-5."""
    if train:
        mean = x.mean(0)
        var = ((x - mean) ** 2).mean(0)
        if stats is not None:
            stats[name] = (mean.detach(), var.detach())
    else:
        mean, var = P[name + ".running_mean"], P[name + ".running_var"]
    return (x - mean) / torch.sqrt(var + 1e-5) * P[name + ".weight"] \
        + P[name + ".bias"]


def mlp_bn(P, name, x, train, stats=None):
    """Linear-BN-ReLU twice."""
    for i in range(2):
        x = linear(P, f"{name}.lin{i}", x)
        x = F.relu(batch_norm(P, f"{name}.bn{i}", x, stats, train))
    return x


def segment_sum(x, ids, n):
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add_(0, ids, x)


def bilstm_scores(P, prefix, seq):
    """seq (T, N, F) -> the summed outputs of a one-layer bidirectional
    LSTM (gates input, forget, cell, output), (T, N)."""
    T, N, _ = seq.shape
    outs = []
    for sfx, steps in (("l0", range(T)), ("l0_reverse", range(T - 1, -1, -1))):
        w_ih, w_hh = P[prefix + "weight_ih_" + sfx], P[prefix + "weight_hh_"
                                                     + sfx]
        b = P[prefix + "bias_ih_" + sfx] + P[prefix + "bias_hh_" + sfx]
        hid = w_hh.shape[1]
        h = seq.new_zeros(N, hid)
        c = seq.new_zeros(N, hid)
        ys = [None] * T
        for t in steps:
            gates = seq[t] @ w_ih.t() + h @ w_hh.t() + b
            i, f, g, o = gates.split(hid, dim=1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys[t] = h
        outs.append(torch.stack(ys))
    return (outs[0].sum(-1) + outs[1].sum(-1))


@torch.no_grad()
def calibrate(ref, P: Dict[str, torch.Tensor], b: RefBatch, m: dict) -> None:
    """Set every batch norm's running statistics in ``P`` to its batch
    statistics over ``b`` in a training-mode forward of the reference
    model ``ref``, as a trained model's estimates follow its
    activations."""
    stats: Dict[str, tuple] = {}
    ref.forward(P, b, m, train=True, stats=stats)
    for name, (mean, var) in stats.items():
        P[name + ".running_mean"] = mean.clone()
        P[name + ".running_var"] = var.clone()


def loss_of(pred, y, kind: str) -> torch.Tensor:
    if kind not in ("l1", "mse"):
        raise NotImplementedError(f"the reference has no loss {kind!r}")
    d = pred - y
    return (d.abs() if kind == "l1" else d * d).mean()


def adam_steps(ref, P0: Dict[str, torch.Tensor], batches: List[RefBatch],
               m: dict, opt: dict, betas=(0.9, 0.999), eps: float = 1e-8):
    """Adam (Kingma and Ba) over ``batches``, one step each, of the
    reference model ``ref`` from the parameters P0 (buffers held fixed):
    (the loss of each step, the first step's gradient of each parameter,
    the parameters after the last step, the first step's predictions)."""
    if opt.get("l2_wd", 0.0):
        raise NotImplementedError("the reference has no weight decay")
    lr = opt["lr"]
    names = [k for k in P0 if not is_buffer(k)]
    P = {k: v.detach().clone() for k, v in P0.items()}
    mom = {k: torch.zeros_like(P[k]) for k in names}
    sq = {k: torch.zeros_like(P[k]) for k in names}
    losses, first, pred1 = [], None, None
    for t, b in enumerate(batches, start=1):
        for k in names:
            P[k].requires_grad_(True)
        pred = ref.forward(P, b, m, train=True)
        if pred1 is None:
            pred1 = pred.detach().clone()
        loss = loss_of(pred, b.y, opt["loss"])
        grads = torch.autograd.grad(loss, [P[k] for k in names])
        losses.append(float(loss.detach()))
        if first is None:
            first = {k: gr.detach().clone() for k, gr in zip(names, grads)}
        with torch.no_grad():
            for k, gr in zip(names, grads):
                mom[k].mul_(betas[0]).add_(gr, alpha=1 - betas[0])
                sq[k].mul_(betas[1]).addcmul_(gr, gr, value=1 - betas[1])
                m_hat = mom[k] / (1 - betas[0] ** t)
                v_hat = sq[k] / (1 - betas[1] ** t)
                P[k] = (P[k] - lr * m_hat / (v_hat.sqrt() + eps)).detach()
    return losses, first, P, pred1
