"""Data-parallel training over a process group (counterpart of
kpgnn_tpu/parallel/dp.py).

Every rank holds the whole model and takes its own member of each group
of P batches.  The step: the loss is the local loss sum over the
GLOBAL count (one all-reduce of the counts, so padded slots dilute
nothing); the gradients are all-reduced by SUM, not averaged, so the
update is the one-device update on the union batch; batch-norm batch
statistics stay local to each rank (not SyncBatchNorm), and the running
statistics are averaged over the ranks weighted by liveness, so the
masked-empty batches that pad a trailing group do not dilute them.
DistributedDataParallel would average the gradients (÷P) and broadcast
rank 0's buffers; neither is the JAX step, so the gradients are reduced
here by hand, in one flat buffer.  Data mode folds the rank into the
dropout generator's seed (``rank_seed``), as the JAX step folds the
device index into its key.
"""
from __future__ import annotations

import functools
from typing import Iterable, Iterator, List, Optional

import numpy as np
import torch

from ..graph.batch import GraphBatch
from ..train.loop import _batch_target_mask, _masked_loss, eval_step
from .mesh import Axes, Mesh


def rank_seed(seed: int, rank: int) -> int:
    """A seed for ``rank``'s generator, folded from the run's seed."""
    return int(np.random.SeedSequence([seed, rank]).generate_state(1)[0])


def mask_empty_batch(b: GraphBatch) -> GraphBatch:
    """Same-shape batch with every node and graph slot masked out: it
    adds zero to losses, metrics and (liveness-weighted) BN statistics,
    so it can pad a trailing partial group without skewing anything."""
    return b.replace(node_mask=torch.zeros_like(b.node_mask),
                     graph_mask=torch.zeros_like(b.graph_mask))


def shard_loader(loader: Iterable[GraphBatch], n_shards: int, index: int
                 ) -> Iterator[GraphBatch]:
    """Member ``index`` of each group of ``n_shards`` batches of the
    stream; a trailing partial group is padded with masked-empty batches
    (not dropped), so every graph is seen every epoch and every rank
    steps as often."""
    buf: List[GraphBatch] = []
    for b in loader:
        buf.append(b)
        if len(buf) == n_shards:
            yield buf[index]
            buf = []
    if buf:
        yield (buf[index] if index < len(buf)
               else mask_empty_batch(buf[-1]))


class ShardStream:
    """Re-iterable view of this rank's member of each group (what the
    Trainer evaluates every epoch)."""

    def __init__(self, loader, n_shards: int, index: int):
        self.loader, self.n_shards, self.index = loader, n_shards, index

    def __iter__(self):
        return shard_loader(self.loader, self.n_shards, self.index)


def reduce_gradients(model, mesh: Mesh, axes: Optional[Axes] = None) -> None:
    """SUM every parameter gradient over ``axes`` in one flat buffer.
    Parameters without a gradient (unused by the model's structure, the
    same on every rank) keep none, as a one-device step leaves them."""
    grads = [p.grad for p in model.parameters() if p.grad is not None]
    if not grads:
        return
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]), axes)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def average_batch_stats(model, live: torch.Tensor, mesh: Mesh,
                        axes: Optional[Axes] = None) -> None:
    """Running statistics averaged over the ranks whose batch had a real
    item (``live`` 1.0 or 0.0), as the JAX step's psum(u·live) / n_live."""
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    if not bufs:
        return
    flat = torch.cat([b.reshape(-1) * live for b in bufs] + [live[None]])
    flat = mesh.all_reduce(flat, axes)
    vals = flat[:-1] / torch.clamp(flat[-1], min=1.0)
    for b, part in zip(bufs, vals.split([b.numel() for b in bufs])):
        b.copy_(part.view_as(b))


def parallel_train_step(model, opt, batch: GraphBatch, loss: str = "l1",
                        generator: Optional[torch.Generator] = None,
                        node_level: bool = False, *, mesh: Mesh,
                        axes: Optional[Axes] = None):
    """One data-parallel optimizer step on this rank's ``batch``
    (``loop.train_step``'s signature); returns (loss sum, count) over the
    whole group, as device tensors."""
    pred = model(batch, train=True, generator=generator)
    lsum, cnt = _masked_loss(pred, batch.y,
                             _batch_target_mask(batch, node_level), loss)
    total = mesh.all_reduce(cnt.detach().clone(), axes)
    opt.zero_grad(set_to_none=True)
    (lsum / torch.clamp(total, min=1.0)).backward()
    reduce_gradients(model, mesh, axes)
    average_batch_stats(model, (cnt.detach() > 0).float(), mesh, axes)
    opt.step()
    sums = mesh.all_reduce(torch.stack([lsum.detach(), cnt.detach()]), axes)
    return sums[0], sums[1]


def make_parallel_train_step(mesh: Mesh, axes: Optional[Axes] = None):
    """``parallel_train_step`` bound to ``mesh``: a ``loop.train_step``
    for ``loop.train_epoch``."""
    return functools.partial(parallel_train_step, mesh=mesh, axes=axes)


def all_reduce_sums(out: dict, mesh: Mesh, axes: Optional[Axes] = None
                    ) -> dict:
    """Every sum of an eval step over ``axes``, in one float64 buffer."""
    keys = sorted(out)
    parts = [out[k].double().reshape(-1) for k in keys]
    flat = mesh.all_reduce(torch.cat(parts), axes)
    return {k: v.view_as(out[k]) for k, v in zip(
        keys, flat.split([p.numel() for p in parts]))}


def parallel_eval_step(model, batch: GraphBatch, loss: str = "l1",
                       metric: str = "same", node_level: bool = False,
                       bn_train_mode: bool = False, *, mesh: Mesh,
                       axes: Optional[Axes] = None) -> dict:
    """``loop.eval_step`` on this rank's batch, every sum (the per-target
    errors included) all-reduced over the group."""
    return all_reduce_sums(eval_step(model, batch, loss, metric, node_level,
                                     bn_train_mode), mesh, axes)


def make_parallel_eval_step(mesh: Mesh, axes: Optional[Axes] = None):
    return functools.partial(parallel_eval_step, mesh=mesh, axes=axes)

