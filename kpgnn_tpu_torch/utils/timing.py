"""Chained throughput timing (counterpart of kpgnn_tpu/utils/timing.py),
the method of ``scripts/tune_banded``.

Eager PyTorch enqueues each op from the host, and on the card a launch
costs several microseconds of host time however small its kernel.  So
``chained_fn`` applies the op ``chain`` times, each application reading
the one before it, and the rate divides by the chain: the dependence
keeps the applications from overlapping or being skipped, and the
clock stops only once the card has finished (``torch.cuda.synchronize``)
when the input lives there.
"""
from __future__ import annotations

import time
from typing import Callable

import torch


def _sync(x: torch.Tensor) -> None:
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def chained_throughput(chained_fn: Callable, x0: torch.Tensor, units: int,
                       iters: int, chain: int) -> float:
    """units/s of one application of the op inside ``chained_fn`` (which
    must apply it ``chain`` dependent times to x0); best of 3 rounds of
    max(iters // chain, 1) calls, after one warm-up call."""
    _sync(x0)
    chained_fn(x0)
    _sync(x0)
    best = 0.0
    reps = max(iters // chain, 1)
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            chained_fn(x0)
        _sync(x0)
        best = max(best, reps * chain * units / (time.perf_counter() - t0))
    return best
