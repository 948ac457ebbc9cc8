"""Train/eval steps and the epoch-level Trainer (counterpart of
kpgnn_tpu/train/loop.py, per-batch path; the resident, parallel and
checkpoint paths are not ported yet).

Losses and metrics are computed under the batch masks: padded graph and
node slots add zero to sums and to counts.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..graph.batch import GraphBatch
from ..nn.inits import init_parameters
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


def train_step(model, opt, batch: GraphBatch, loss: str = "l1",
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer step; returns (loss sum, count) as device tensors."""
    pred = model(batch, train=True, generator=generator)
    lsum, cnt = _masked_loss(pred, batch.y, batch.graph_mask, loss)
    opt.zero_grad(set_to_none=True)
    (lsum / torch.clamp(cnt, min=1.0)).backward()
    opt.step()
    return lsum.detach(), cnt.detach()


@torch.no_grad()
def eval_step(model, batch: GraphBatch, loss: str = "l1"
              ) -> Dict[str, torch.Tensor]:
    """Sums of one batch as device tensors, for exact epoch aggregation:
    ``loss_sum`` and ``count``, and for cross entropy ``correct`` (real
    graphs whose argmax is the label)."""
    pred = model(batch, train=False)
    lsum, cnt = _masked_loss(pred, batch.y, batch.graph_mask, loss)
    out = {"loss_sum": lsum, "count": cnt}
    if loss == "cross_entropy":
        out["correct"] = ((pred.argmax(-1) == batch.y.long())
                          & batch.graph_mask).sum()
    return out


def train_epoch(model, opt, batches, loss: str = "l1",
                generator: Optional[torch.Generator] = None
                ) -> Tuple[float, np.ndarray]:
    """Mean train loss of one epoch and the per-step losses.  Step
    results stay on the device until the epoch ends (one sync)."""
    sums: List[torch.Tensor] = []
    counts: List[torch.Tensor] = []
    for batch in batches:
        lsum, cnt = train_step(model, opt, batch, loss, generator)
        sums.append(lsum)
        counts.append(cnt)
    if not sums:
        return 0.0, np.zeros(0)
    s = torch.stack(sums).double().cpu().numpy()
    c = torch.stack(counts).double().cpu().numpy()
    return float(s.sum() / max(c.sum(), 1.0)), s / np.maximum(c, 1.0)


def evaluate(model, batches, loss: str = "l1") -> Dict[str, float]:
    """Mean loss (and, for cross entropy, accuracy) over the real graphs
    of all batches, with one host sync."""
    steps = [eval_step(model, b, loss) for b in batches]
    sums = {k: float(torch.stack([s[k] for s in steps]).double().sum())
            for k in steps[0]}
    count = max(sums["count"], 1.0)
    out = {"loss": sums["loss_sum"] / count, "count": count}
    if "correct" in sums:
        out["accuracy"] = sums["correct"] / count
    return out


@dataclasses.dataclass
class Trainer:
    """Epoch loop with plateau LR on the validation metric, best-val
    gating of the test metrics and optional min-lr stopping, on one
    device.  ``metric_mode="min"`` tracks the validation loss, "max" its
    accuracy; ``use_scheduler=False`` keeps the LR constant, as the
    expressiveness scripts do.  The plateau schedule is ported in "min"
    mode only, so "max" requires ``use_scheduler=False``."""

    model: torch.nn.Module
    cfg: TrainConfig
    loss: str = "l1"
    metric_mode: str = "min"
    use_scheduler: bool = True
    logger: Optional[object] = None
    device: str = "cuda"

    def log(self, msg):
        if self.logger:
            self.logger.info(msg)

    def fit(self, train_loader, val_loader=None, test_loader=None,
            seed: Optional[int] = None,
            epoch_callback: Optional[Callable] = None):
        """Initialize the model from ``seed`` (on the CPU, so the weights
        do not depend on the device), move it to the device and train.
        Returns (model, results)."""
        if self.cfg.load_path or self.cfg.save_checkpoints \
                or self.cfg.profile_dir:
            raise NotImplementedError(
                "checkpoints and profiling are not ported yet "
                "(ROADMAP.md, Queue 1)")
        if self.metric_mode == "max" and self.use_scheduler:
            raise NotImplementedError(
                "the plateau LR schedule runs in 'min' mode only; pass "
                "use_scheduler=False with metric_mode='max'")
        device = resolve_device(self.device)
        seed = self.cfg.seed if seed is None else seed
        model = init_parameters(self.model, seed).to(device)
        opt = make_optimizer(model.parameters(), self.cfg.lr,
                             self.cfg.l2_wd)
        generator = torch.Generator(device=device).manual_seed(seed)
        cached: Dict[int, list] = {}

        def on_device(loader):
            return (b.to(device) for b in loader)

        def run_eval(loader):
            if id(loader) not in cached:        # eval batches stay resident
                cached[id(loader)] = list(on_device(loader))
            return evaluate(model, cached[id(loader)], loss=self.loss)

        sched = ReduceLROnPlateau(factor=self.cfg.factor,
                                  patience=self.cfg.patience,
                                  min_lr=self.cfg.min_lr)
        maximize = self.metric_mode == "max"
        key = "accuracy" if maximize else "loss"
        best_val = -math.inf if maximize else math.inf
        best_test: Dict[str, float] = {}
        best_epoch = -1
        history = []
        interrupted = False
        for epoch in range(self.cfg.num_epochs):
            try:
                t0 = time.time()
                train_loss, step_losses = train_epoch(
                    model, opt, on_device(train_loader), self.loss,
                    generator)
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
                        new_lr = sched.step(metric, lr)
                        if new_lr != lr:
                            set_lr(opt, new_lr)
                    if metric > best_val if maximize else metric < best_val:
                        best_val, best_epoch = metric, epoch
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
