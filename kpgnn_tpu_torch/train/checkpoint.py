"""Checkpoints: best-k saver and plain save/load (counterpart of
kpgnn_tpu/train/checkpoint.py).

A checkpoint holds the model's ``state_dict`` (parameters and norm
buffers), the optimizer's ``state_dict`` (Adam moments, step counts, lr)
and a ``meta`` dict, written with ``torch.save`` to a temporary file and
moved into place, so a reader never sees half a file.  Loading maps the
tensors onto ``map_location`` and copies them into the caller's model and
optimizer, so a checkpoint written on the card restores bit for bit on
the CPU and back.  The files are ``step_<n>.pt`` and ``best.pt``: the JAX
package's msgpack ``*.ckpt`` files are never opened.  The plateau
schedule's state is not saved, as in the JAX package.
"""
from __future__ import annotations

import heapq
import os
from typing import Optional

import torch


def save_checkpoint(path: str, model: torch.nn.Module,
                    opt: Optional[torch.optim.Optimizer] = None,
                    meta: Optional[dict] = None) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"model": model.state_dict(),
               "opt": None if opt is None else opt.state_dict(),
               "meta": meta or {}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def read_checkpoint(path: str, map_location="cpu") -> dict:
    """The checkpoint's {"model", "opt", "meta"}, its tensors on
    ``map_location``."""
    return torch.load(path, map_location=map_location, weights_only=True)


def load_checkpoint(path: str, model: torch.nn.Module,
                    opt: Optional[torch.optim.Optimizer] = None,
                    map_location="cpu") -> dict:
    """Restores ``model`` (strictly: every parameter and buffer) and, if
    given, ``opt`` from ``path``; returns the checkpoint's meta."""
    payload = read_checkpoint(path, map_location)
    model.load_state_dict(payload["model"], strict=True)
    if opt is not None:
        if payload["opt"] is None:
            raise ValueError(f"{path} holds no optimizer state")
        opt.load_state_dict(payload["opt"])
    return payload["meta"]


class CheckpointSaver:
    """Keep the ``max_checkpoints`` best epochs by a scalar metric, and the
    best so far in ``best.pt`` (the JAX saver's eviction rule)."""

    def __init__(self, save_dir: str, max_checkpoints: int = 3,
                 maximize_metric: bool = False, logger=None):
        self.save_dir = save_dir
        self.max_checkpoints = max_checkpoints
        self.maximize = maximize_metric
        self.logger = logger
        self.best: Optional[float] = None
        self._heap: list = []          # (priority, uid, path); min-heap
        self._uid = 0
        os.makedirs(save_dir, exist_ok=True)

    def is_best(self, metric: Optional[float]) -> bool:
        if metric is None:
            return False
        if self.best is None:
            return True
        return metric > self.best if self.maximize else metric < self.best

    def save(self, step: int, model: torch.nn.Module,
             opt: Optional[torch.optim.Optimizer], metric: float) -> str:
        meta = {"step": step, "metric": metric}
        path = os.path.join(self.save_dir, f"step_{step}.pt")
        save_checkpoint(path, model, opt, meta)
        if self.is_best(metric):
            self.best = metric
            save_checkpoint(os.path.join(self.save_dir, "best.pt"), model,
                            opt, meta)
            if self.logger:
                self.logger.info(f"new best ({metric}) at step {step}")
        priority = metric if self.maximize else -metric
        heapq.heappush(self._heap, (priority, self._uid, path))
        self._uid += 1
        while len(self._heap) > self.max_checkpoints:
            _, _, worst = heapq.heappop(self._heap)
            try:
                os.remove(worst)
            except OSError:
                pass
        return path
