"""Profiling helpers (counterpart of kpgnn_tpu/utils/profiling.py).

``trace(dir)`` records a block with ``torch.profiler`` (CPU activity, and
CUDA activity when ``cuda`` is true: by default when CUDA is available)
and writes one chrome trace, ``trace_<ms>.pt.trace.json``, into ``dir``,
which ``utils.trace_summary`` reads; ``timed`` is a minimal wall-clock
context.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import torch


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{int(time.time() * 1e3)}.pt.trace.json"))


@contextlib.contextmanager
def timed(label: str = "", sink=print):
    t0 = time.perf_counter()
    yield
    sink(f"{label}: {time.perf_counter() - t0:.4f}s")
