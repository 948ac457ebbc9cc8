"""Train/eval steps and the epoch-level Trainer (counterpart of
kpgnn_tpu/train/loop.py: the per-batch and the resident paths, with
checkpoints and profiling, on one device or, with a mesh, over a process
group in data-parallel or node-sharded mode, parallel/).

Losses and metrics are computed under the batch masks: padded graph and
node slots add zero to sums and to counts.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import os
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.batch import GraphBatch
from ..nn.inits import init_parameters
from ..utils.profiling import span
from .config import TrainConfig
from .lr import ReduceLROnPlateau
from .state import get_lr, make_optimizer, set_lr


def resolve_device(device: str) -> torch.device:
    """The device to run on.  A CUDA device that is not available raises:
    nothing falls back to the CPU silently."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but CUDA is not available; pass "
            "--device cpu to run on the CPU")
    return dev


def _masked_loss(pred, y, mask, loss: str):
    """Returns (sum of per-item losses over real items, item count)."""
    pred = pred.float()
    m = mask.float()
    if loss == "cross_entropy":
        item = F.cross_entropy(pred, y.long(), reduction="none")
    else:
        y = y.to(pred.dtype)
        if y.shape != pred.shape:
            if y.numel() == pred.numel():
                y = y.reshape(pred.shape)
            else:
                raise ValueError(f"pred {tuple(pred.shape)} vs y "
                                 f"{tuple(y.shape)}")
        diff = pred - y
        item = diff.abs() if loss == "l1" else diff * diff
        if item.dim() > 1:
            item = item.mean(dim=tuple(range(1, item.dim())))
    return (item * m).sum(), m.sum()


def _batch_target_mask(batch: GraphBatch, node_level: bool):
    return batch.node_mask if node_level else batch.graph_mask


def train_step(model, opt, batch: GraphBatch, loss: str = "l1",
               generator: Optional[torch.Generator] = None,
               node_level: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step; returns (loss sum, count) as device tensors.
    ``node_level`` targets are counted over the real nodes, others over
    the real graphs."""
    with span("step.forward"):
        pred = model(batch, train=True, generator=generator)
        lsum, cnt = _masked_loss(pred, batch.y,
                                 _batch_target_mask(batch, node_level), loss)
    with span("step.backward"):
        opt.zero_grad(set_to_none=True)
        (lsum / torch.clamp(cnt, min=1.0)).backward()
    with span("step.optimizer"):
        opt.step()
    return lsum.detach(), cnt.detach()


@contextlib.contextmanager
def frozen_buffers(model) -> Iterator[None]:
    """Within the block the model may update its buffers (a batch norm's
    running statistics in train mode); on exit every buffer holds its
    value from before the block again, bit for bit."""
    saved = [(b, b.detach().clone()) for b in model.buffers()]
    try:
        yield
    finally:
        with torch.no_grad():
            for b, v in saved:
                b.copy_(v)


@torch.no_grad()
def eval_step(model, batch: GraphBatch, loss: str = "l1",
              metric: str = "same", node_level: bool = False,
              bn_train_mode: bool = False) -> Dict[str, torch.Tensor]:
    """Sums of one batch as device tensors, for exact epoch aggregation:
    ``loss_sum`` and ``count``; ``correct`` (real items whose argmax is
    the label) for accuracy or cross entropy; ``mae_sum`` / ``mse_sum``
    when ``metric`` asks for an error the loss is not; and, for a 2-D
    graph-level y under an l1 or mse loss, ``abs_per_target``.  ``metric``
    is "same" (the loss), "mae", "mse" or "accuracy"; the items are the
    real nodes under ``node_level``, else the real graphs.
    ``bn_train_mode`` runs the forward in train mode, so batch norms
    normalize with the batch's statistics (the SR25 protocol, reference:
    train_SR.py:46-47), and discards the running-statistics updates, as
    the JAX eval step discards its mutated ``batch_stats``; dropout, if
    any, draws from a generator seeded 0 (the JAX step's fixed key)."""
    with span("step.forward"):
        if bn_train_mode:
            gen = torch.Generator(
                device=batch.node_mask.device).manual_seed(0)
            with frozen_buffers(model):
                pred = model(batch, train=True, generator=gen)
        else:
            pred = model(batch, train=False)
        mask = _batch_target_mask(batch, node_level)
        lsum, cnt = _masked_loss(pred, batch.y, mask, loss)
    out = {"loss_sum": lsum, "count": cnt}
    which = loss if metric == "same" else metric
    if which == "accuracy" or loss == "cross_entropy":
        out["correct"] = ((pred.argmax(-1) == batch.y.long()) & mask).sum()
    if which in ("mae", "l1") and loss != "l1":
        out["mae_sum"] = _masked_loss(pred, batch.y, mask, "l1")[0]
    if which == "mse" and loss != "mse":
        out["mse_sum"] = _masked_loss(pred, batch.y, mask, "mse")[0]
    if (not node_level and batch.y is not None and batch.y.dim() == 2
            and loss in ("l1", "mse")):
        m = mask.to(pred.dtype)[:, None]
        out["abs_per_target"] = ((pred.float() - batch.y.float()).abs()
                                 * m).sum(0)
    return out


PREFETCH_DEPTH = 2          # batches device_prefetch copies ahead
EVAL_CACHE_BYTES = 1 << 30  # DeviceCacheLoader's cap (the JAX package's)


def device_prefetch(iterable, device):
    """The batches of ``iterable`` on ``device``, copied by a helper thread
    (``loader.background_iter``) at most PREFETCH_DEPTH batches ahead of
    the consumer (kpgnn_tpu/train/loop.py:150): ``b.to(device)`` off the
    dispatch thread.  Cancellation-safe: abandoning the generator stops
    the thread."""
    from .loader import background_iter

    def copies():
        for b in iterable:
            with span("prefetch.copy"):
                b = b.to(device)
            yield b
    return background_iter(copies, maxsize=PREFETCH_DEPTH)


def _nbytes(obj) -> int:
    """Bytes of the tensors of a batch (or a part of one), through
    dataclass fields, tuples and lists."""
    if isinstance(obj, torch.Tensor):
        return obj.numel() * obj.element_size()
    if isinstance(obj, (tuple, list)):
        return sum(map(_nbytes, obj))
    if dataclasses.is_dataclass(obj):
        return sum(_nbytes(getattr(obj, f.name))
                   for f in dataclasses.fields(obj))
    return 0


class DeviceCacheLoader:
    """An eval loader whose (deterministic) batches stay on the device
    (kpgnn_tpu/train/loop.py:166): the first pass prefetches them
    (``device_prefetch``) and records them up to EVAL_CACHE_BYTES; later
    passes replay the record.  Past the cap it keeps nothing and streams
    every pass."""

    def __init__(self, loader, device):
        self.loader = loader
        self.device = device
        self._cache = None

    def __iter__(self):
        if self._cache is not None:
            return iter(self._cache)
        return self._fill()

    def _fill(self):
        cache, used, overflow = [], 0, False
        for b in device_prefetch(iter(self.loader), self.device):
            if not overflow:
                used += _nbytes(b)
                if used <= EVAL_CACHE_BYTES:
                    cache.append(b)
                else:
                    cache, overflow = None, True
            yield b
        if not overflow:
            self._cache = cache

    def __len__(self):
        return len(self.loader)


def train_epoch(model, opt, batches, loss: str = "l1",
                generator: Optional[torch.Generator] = None,
                node_level: bool = False,
                step: Callable = train_step) -> Tuple[float, np.ndarray]:
    """Mean train loss of one epoch and the per-step losses.  Step
    results stay on the device until the epoch ends (one sync).
    ``step`` has ``train_step``'s signature and result (the parallel
    steps return sums over the whole group)."""
    sums: List[torch.Tensor] = []
    counts: List[torch.Tensor] = []
    for batch in batches:
        with span("loop.step"):
            lsum, cnt = step(model, opt, batch, loss, generator, node_level)
        sums.append(lsum)
        counts.append(cnt)
    if not sums:
        return 0.0, np.zeros(0)
    s = torch.stack(sums).double().cpu().numpy()
    c = torch.stack(counts).double().cpu().numpy()
    return float(s.sum() / max(c.sum(), 1.0)), s / np.maximum(c, 1.0)


def evaluate(model, batches, loss: str = "l1", metric: str = "same",
             node_level: bool = False, bn_train_mode: bool = False,
             step: Callable = eval_step) -> Dict[str, float]:
    """The epoch metrics over the real graphs (nodes, under
    ``node_level``) of all batches (``summarize_eval_sums``), with one
    host sync; ``bn_train_mode`` as in ``eval_step``, whose signature and
    result ``step`` has."""
    steps = []
    for b in batches:
        with span("loop.step"):
            steps.append(step(model, b, loss, metric, node_level,
                              bn_train_mode))
    sums = {k: torch.stack([s[k] for s in steps]).double().sum(0).cpu()
            .numpy() for k in steps[0]}
    return summarize_eval_sums(sums)


def summarize_eval_sums(sums: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Epoch metrics from summed eval-step outputs: ``loss`` and
    ``count``, and ``accuracy``, ``mae``, ``mse``, ``mae_per_target``
    where their sums are present."""
    cnt = max(float(sums.get("count", 0.0)), 1.0)
    out = {"loss": float(sums.get("loss_sum", 0.0)) / cnt, "count": cnt}
    for key, name in (("correct", "accuracy"), ("mae_sum", "mae"),
                      ("mse_sum", "mse")):
        if key in sums:
            out[name] = float(sums[key]) / cnt
    if "abs_per_target" in sums:
        out["mae_per_target"] = np.asarray(sums["abs_per_target"]) / cnt
    return out


RESIDENT_MAX_BYTES = 4 << 30        # KPGNN_RESIDENT_MAX_BYTES's default


def resident_rule(resident: str, loader) -> Tuple[bool, str]:
    """Whether ``loader``'s epochs run resident, and why (the JAX
    Trainer's rule, kpgnn_tpu/train/loop.py:336-365).  Dense, COO and
    banded loaders have a store.  "on" takes it, "off" never does; "auto"
    takes a dense or banded store that fits ``KPGNN_RESIDENT_MAX_BYTES``
    (default 4 GiB), and a COO store only when it fits and both its node
    and its edge slots are at least half full on average (per-graph slots
    of a skewed dataset waste the compute COO's compact packing saves).
    The banded store is sized at the dtype it keeps its mask in
    (``banded_store_nbytes``), so a KPGCN store counts 4 bytes an entry
    where the JAX estimate counts 1."""
    from .resident import (banded_store_nbytes, coo_store_nbytes,
                           plan_banded_store_shapes, store_nbytes)

    mode = getattr(loader, "mode", None)
    if resident == "off" or mode not in ("dense", "coo", "banded"):
        return False, f"--resident {resident}, loader mode {mode}"
    if resident == "on":
        return True, "--resident on"
    cap = float(os.environ.get("KPGNN_RESIDENT_MAX_BYTES",
                               RESIDENT_MAX_BYTES))
    gs, node_y = loader.graphs, loader.y_is_node_level
    if mode == "dense":
        nbytes = store_nbytes(gs, loader.n_slot, node_y)
        return nbytes <= cap, f"auto: dense store {nbytes} B, cap {cap:.0f}"
    if mode == "banded":
        tile, halo, n_slot, spill = plan_banded_store_shapes(gs)
        nbytes = banded_store_nbytes(gs, n_slot, tile, halo, spill,
                                     loader.v1, loader.vk, node_y,
                                     loader.banded_gcn_norm)
        return nbytes <= cap, (f"auto: banded store {nbytes} B, cap "
                               f"{cap:.0f}")
    ns = max(g.num_nodes for g in gs)
    es = max(g.num_edges for g in gs)
    nbytes = coo_store_nbytes(gs, ns, es, node_y)
    fill_n = sum(g.num_nodes for g in gs) / (len(gs) * ns)
    fill_e = sum(g.num_edges for g in gs) / max(len(gs) * es, 1)
    return (nbytes <= cap and min(fill_n, fill_e) >= 0.5,
            f"auto: COO store {nbytes} B, cap {cap:.0f}, node slots "
            f"{fill_n:.3f} full, edge slots {fill_e:.3f} full (needs 0.5)")


@dataclasses.dataclass
class Trainer:
    """Epoch loop with plateau LR on the validation metric, best-val
    gating of the test metrics and optional min-lr stopping, on one
    device.  ``metric_mode="min"`` tracks the validation loss, "max" its
    accuracy; the plateau schedule follows the same metric in the same
    mode, or, with ``sched_on="loss"``, the validation loss in "min" mode
    even on an accuracy task; ``use_scheduler=False`` keeps the LR
    constant, as the expressiveness scripts do.  ``eval_metric`` adds an
    error to every evaluation (``evaluate``'s ``metric``: QM9 trains on
    MSE and reports the MAE).  ``bn_train_mode_eval`` evaluates with
    batch-statistics norms and leaves the running statistics as they were
    (``eval_step``'s ``bn_train_mode``; SR25).  ``node_level`` takes the
    loss and metrics over the real nodes (node heads).  ``resident``
    ("auto", "on" or "off", ``resident_rule``) keeps a dense, COO or
    banded dataset on the device and gathers each batch there
    (train/resident.py), in the loader's shuffle order.

    Checkpoints (train/checkpoint.py): ``cfg.load_path`` warm-starts the
    model and the optimizer from a checkpoint; ``checkpoint_dir``, or
    ``<cfg.save_dir>/checkpoints`` under ``cfg.save_checkpoints``, gets
    one on every epoch whose validation metric is the best so far (the
    ``max_checkpoints`` best kept, and ``best.pt``).  ``cfg.profile_dir``
    gets a torch.profiler chrome trace of epoch 1's training (epoch 0's
    when there is one epoch).

    ``mesh`` (parallel/mesh.Mesh) trains on its device over its process
    group: ``parallel_mode`` "data" gives each rank its own member of
    each group of batches (parallel/dp.py; resident epochs gather each
    rank's column of the index array), "node" shards every batch's nodes
    over the mesh's first axis (parallel/partition.py; never resident;
    ``partition_plans`` {"pallas": {...}} or {"banded": {...}} attaches
    the local plans at partition time, the loader collating COO).  Every
    rank computes the same metrics; only rank 0 logs, writes checkpoints
    and traces."""

    model: torch.nn.Module
    cfg: TrainConfig
    loss: str = "l1"
    node_level: bool = False
    metric_mode: str = "min"
    sched_on: str = "metric"
    use_scheduler: bool = True
    eval_metric: str = "same"
    bn_train_mode_eval: bool = False
    logger: Optional[object] = None
    checkpoint_dir: Optional[str] = None
    max_checkpoints: int = 3
    device: str = "cuda"
    resident: str = "auto"
    mesh: Optional[object] = None
    parallel_mode: str = "data"
    partition_plans: Optional[dict] = None

    def log(self, msg):
        if self.logger and (self.mesh is None or self.mesh.rank == 0):
            self.logger.info(msg)

    def fit(self, train_loader, val_loader=None, test_loader=None,
            seed: Optional[int] = None,
            epoch_callback: Optional[Callable] = None):
        """Initialize the model from ``seed`` (on the CPU, so the weights
        do not depend on the device), or from ``cfg.load_path``, move it
        to the device and train.  Returns (model, results)."""
        from .checkpoint import CheckpointSaver, read_checkpoint

        mesh, node_mode = self.mesh, self.parallel_mode == "node"
        if mesh is not None and self.parallel_mode not in ("data", "node"):
            raise ValueError(f"parallel_mode {self.parallel_mode!r}")
        rank0 = mesh is None or mesh.rank == 0
        device = resolve_device(str(mesh.device) if mesh is not None
                                else self.device)
        seed = self.cfg.seed if seed is None else seed
        model = init_parameters(self.model, seed)
        warm = (read_checkpoint(self.cfg.load_path) if self.cfg.load_path
                else None)
        if warm is not None:        # after init, before the device move
            model.load_state_dict(warm["model"], strict=True)
        model = model.to(device)
        opt = make_optimizer(model.parameters(), self.cfg.lr,
                             self.cfg.l2_wd)
        if warm is not None:
            opt.load_state_dict(warm["opt"])
            self.log(f"warm start from {self.cfg.load_path}")
        # this rank's view of a loader and its steps; data mode folds the
        # rank into the dropout seed, node mode keeps one generator on
        # every rank (parallel/partition.py)
        gen_seed, wrap = seed, None
        train_step_fn, eval_step_fn = train_step, eval_step
        if mesh is not None and node_mode:
            from ..parallel.partition import (PartitionedLoader,
                                              make_sharded_eval_step,
                                              make_sharded_train_step)
            axis = mesh.axis_names[0]
            wrap = functools.partial(
                PartitionedLoader, n_shards=mesh.axis_size(axis),
                rank=mesh.axis_index(axis), group=mesh.group(axis),
                node_level=self.node_level, **(self.partition_plans or {}))
            train_step_fn = make_sharded_train_step(mesh, axis)
            eval_step_fn = make_sharded_eval_step(mesh, axis)
        elif mesh is not None:
            from ..parallel.dp import (ShardStream, make_parallel_eval_step,
                                       make_parallel_train_step, rank_seed)
            gen_seed = rank_seed(seed, mesh.rank)
            wrap = functools.partial(ShardStream, n_shards=mesh.size,
                                     index=mesh.rank)
            train_step_fn = make_parallel_train_step(mesh)
            eval_step_fn = make_parallel_eval_step(mesh)
        generator = torch.Generator(device=device).manual_seed(gen_seed)
        # eval batches stay on the device: one DeviceCacheLoader a loader
        # on one device (capped, kpgnn_tpu/train/loop.py:477), every
        # shard of a parallel rank
        cached: Dict[int, object] = {}

        def on_device(loader):
            return (b.to(device) for b in loader)

        use_resident, why = resident_rule(self.resident, train_loader)
        if use_resident and mesh is not None and node_mode:
            use_resident, why = False, "--parallel node is never resident"
        stores: Dict[int, object] = {}
        if use_resident:
            from .resident import (build_banded_store, build_coo_store,
                                   build_dense_store, epoch_index_chunks,
                                   make_resident_eval,
                                   make_resident_train_epoch,
                                   plan_banded_store_shapes)
            mode = train_loader.mode
            # COO and banded stores: one slot layout over every split's
            # store of that mode
            slot_graphs = [g for l in (train_loader, val_loader,
                                       test_loader)
                           if l is not None
                           and getattr(l, "mode", None) == mode
                           for g in l.graphs]
            if mode == "coo":
                n_slot = max(g.num_nodes for g in slot_graphs)
                e_slot = max(g.num_edges for g in slot_graphs)
            elif mode == "banded":
                banded_shapes = plan_banded_store_shapes(slot_graphs)

            def store_for(loader):
                if id(loader) in stores:
                    return stores[id(loader)]
                if mode == "coo":
                    store = build_coo_store(loader.graphs, n_slot, e_slot,
                                            loader.y_is_node_level, device)
                elif mode == "banded":
                    store = build_banded_store(
                        loader.graphs, loader.v1, loader.vk,
                        loader.y_is_node_level,
                        gcn_norm=loader.banded_gcn_norm,
                        shapes=banded_shapes, device=device)
                else:
                    store = build_dense_store(
                        loader.graphs, loader.n_slot, loader.v1, loader.vk,
                        loader.y_is_node_level, device)
                stores[id(loader)] = store
                return store
            train_store = store_for(train_loader)
            if mesh is not None:
                from .resident import (make_parallel_resident_eval,
                                       make_parallel_resident_train_epoch,
                                       parallel_epoch_index_chunks)
                resident_epoch = make_parallel_resident_train_epoch(
                    model, opt, mesh, self.loss, self.node_level)
                resident_eval = make_parallel_resident_eval(
                    model, mesh, self.loss, self.node_level,
                    self.eval_metric, self.bn_train_mode_eval)
            else:
                resident_epoch = make_resident_train_epoch(
                    model, opt, self.loss, self.node_level)
                resident_eval = make_resident_eval(
                    model, self.loss, self.node_level, self.eval_metric,
                    self.bn_train_mode_eval)
            self.log(f"resident store: {len(train_loader.graphs)} graphs "
                     f"on {device}, {train_store.nbytes()} B, "
                     f"{train_loader.mode} slots of {train_store.n_slot} "
                     f"nodes, one gathered batch a step ({why})")
        elif getattr(train_loader, "mode", None) in ("dense", "coo",
                                                     "banded"):
            self.log(f"per-batch epochs ({why})")
        if mesh is not None:
            self.log(f"{self.parallel_mode}-parallel over {mesh.size} ranks "
                     f"({mesh.backend}, mesh "
                     f"{dict(zip(mesh.axis_names, mesh.shape))}), rank 0 "
                     f"on {device}")

        def chunks(order, batch_size, pad_idx):
            if mesh is not None:
                return parallel_epoch_index_chunks(order, batch_size,
                                                   mesh.size, pad_idx)
            return epoch_index_chunks(order, batch_size, pad_idx)

        def run_eval(loader):
            if use_resident and getattr(loader, "mode", None) \
                    == train_loader.mode:
                store = store_for(loader)
                return resident_eval(store, chunks(
                    np.arange(len(loader.graphs)), loader.batch_size,
                    store.num_graphs))
            if id(loader) not in cached:
                cached[id(loader)] = (
                    DeviceCacheLoader(loader, device) if wrap is None
                    else list(on_device(wrap(loader))))
            return evaluate(model, cached[id(loader)], self.loss,
                            self.eval_metric, self.node_level,
                            self.bn_train_mode_eval, step=eval_step_fn)

        def run_train():
            if not use_resident:
                stream = train_loader if wrap is None else wrap(train_loader)
                return train_epoch(model, opt, on_device(stream), self.loss,
                                   generator, self.node_level,
                                   step=train_step_fn)
            G = len(train_loader.graphs)
            order = (train_loader.rng.permutation(G)
                     if train_loader.shuffle else np.arange(G))
            if getattr(train_loader, "drop_last", False):
                bs = train_loader.batch_size
                order = order[:(len(order) // bs) * bs]
            return resident_epoch(train_store, chunks(
                order, train_loader.batch_size, train_store.num_graphs),
                generator)

        maximize = self.metric_mode == "max"
        sched = ReduceLROnPlateau(
            factor=self.cfg.factor, patience=self.cfg.patience,
            min_lr=self.cfg.min_lr,
            mode="min" if self.sched_on == "loss" else self.metric_mode)
        ckpt_dir = self.checkpoint_dir
        if ckpt_dir is None and self.cfg.save_checkpoints \
                and self.cfg.save_dir:
            ckpt_dir = os.path.join(self.cfg.save_dir, "checkpoints")
        saver = (None if ckpt_dir is None or not rank0 else CheckpointSaver(
            ckpt_dir, self.max_checkpoints, maximize_metric=maximize,
            logger=self.logger))
        # trace the second epoch (past warm-up); the first if there is
        # only one, so --num_epochs 1 still writes a trace
        profile_epoch = 1 if self.cfg.num_epochs > 1 else 0
        key = "accuracy" if maximize else "loss"
        best_val = -math.inf if maximize else math.inf
        best_test: Dict[str, float] = {}
        best_epoch = -1
        history = []
        interrupted = False
        for epoch in range(self.cfg.num_epochs):
            try:
                t0 = time.time()
                if (self.cfg.profile_dir and epoch == profile_epoch
                        and rank0):
                    from ..utils.profiling import trace
                    with trace(self.cfg.profile_dir,
                               cuda=device.type == "cuda"):
                        train_loss, step_losses = run_train()
                    self.log(f"profiler trace of epoch {epoch} -> "
                             f"{self.cfg.profile_dir}")
                else:
                    train_loss, step_losses = run_train()
                row = {"epoch": epoch, "train_loss": train_loss,
                       "lr": get_lr(opt), "seconds": time.time() - t0,
                       "step_losses": step_losses}
                if val_loader is not None:
                    val = run_eval(val_loader)
                    row.update({f"val_{k}": v for k, v in val.items()
                                if k != "count"})
                    metric = val[key]
                    if self.use_scheduler:
                        lr = get_lr(opt)
                        new_lr = sched.step(
                            val["loss"] if self.sched_on == "loss"
                            else metric, lr)
                        if new_lr != lr:
                            set_lr(opt, new_lr)
                    if metric > best_val if maximize else metric < best_val:
                        best_val, best_epoch = metric, epoch
                        if saver is not None:
                            saver.save(epoch, model, opt, metric)
                        if test_loader is not None:
                            best_test = run_eval(test_loader)
                            row.update({f"test_{k}": v
                                        for k, v in best_test.items()
                                        if k != "count"})
                history.append(row)
                self.log(" ".join(
                    f"{k}={v:.5f}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in row.items()
                    if not isinstance(v, np.ndarray)))
                if epoch_callback is not None:
                    epoch_callback(epoch, model, row)
                if (self.cfg.stop_at_min_lr
                        and get_lr(opt) <= self.cfg.min_lr * (1 + 1e-5)):
                    self.log(f"lr reached min_lr at epoch {epoch}; stopping")
                    break
            except KeyboardInterrupt:
                self.log(f"interrupted at epoch {epoch}")
                interrupted = True
                break
        return model, {"best_val": best_val, "best_epoch": best_epoch,
                       "best_test": best_test, "history": history,
                       "interrupted": interrupted}
