"""Profiling: the program's spans, the Trainer's trace and the launch
counts of the hand-written kernels (counterpart of
kpgnn_tpu/utils/profiling.py).

``span(name)`` marks a stretch of the program.  While no
``torch.profiler`` records, it returns one shared null context, so a span
costs a flag read; while one records (the Trainer's ``--profile_dir``,
any caller's ``torch.profiler.profile``), it returns
``torch.profiler.record_function(name)``, and the span lands in the
profiler's chrome trace as a ``user_annotation`` event beside the
operators, the CUDA runtime calls and the device's kernels, on the same
clock.  Spans of one thread nest; a batch's spans on the loader and
prefetch threads pair with the loop's by order (each stage hands its
batches on through one FIFO queue).  ``SPANS`` names every span.  A
profiler records the spans of the threads it traces: its own, the
autograd engine's, and every thread where it is started with
``profile_all_threads`` (as ``trace`` starts it).

A span still open when its profiler stops ends in the trace where the
profiler finishes its trace, after the last device event, and so
stretches the trace's span.  A caller may stop its profiler inside the
``next()`` on the batches it hands the loop; so ``loop.wait`` covers
the wait on ``loader.background_iter``'s queue (on the dispatching
thread the loop's wait for its next batch, on the prefetch thread the
wait for the loader's), not that ``next()``.

``trace(dir)`` records a block with ``torch.profiler`` on every thread
(CPU activity, and CUDA activity when ``cuda`` is true: by default when
CUDA is available) and writes one chrome trace,
``trace_<ms>.pt.trace.json``, into ``dir``, which ``utils.trace_summary``
reads.

``LAUNCHES`` counts every launch of the port's hand-written kernels by
(family, variant, shape): the family is the wrapper that launched it
(``gather_segment_sum``, ``sorted_segment_sum``, ``bilstm``), the
variant its ``variant_name`` and the shape the row width D, or (T, H)
for the BiLSTM.  One family counts no kernel of its own: ``segment_csr``
counts each sorted sum on the card by the CSR it read, ``batch`` (the
caller's, carried by the batch) or ``ids`` (built from the ids on the
device), with the number of segments as its shape.  ``launch_counts``
reads one family; ``reset_launch_counts`` zeroes every family.
"""
from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Optional

import torch
import torch.autograd.profiler as _autograd_profiler

SPANS = (
    "loop.wait",          # a wait on a background producer's queue
    "loop.step",          # each step call of train_epoch / evaluate
    "step.forward",       # model and loss (train_step, eval_step)
    "step.backward",      # zero_grad and backward
    "step.optimizer",     # the optimizer's step
    "model.encode",       # the backbone's inputs: encoder, rd, peripheral
    "model.layer",        # a layer: conv, norm, dropout, residual, vn update
    "layer.aggregate",    # a conv's path encoding, k-hop sum, peripheral
    "layer.combine",      # a conv's hop combine (attention or geometric)
    "layer.mlp",          # a conv's MLP
    "model.readout",      # jumping knowledge and the output projection
    "model.pool",         # a graph head's heads.pool_nodes
    "loader.collate",     # one batch collated (GraphLoader's producer)
    "loader.build_plan",  # a batch's kernel plan, inside loader.collate
    "prefetch.copy",      # a batch's copy to the device (device_prefetch)
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context marking ``name`` (one of ``SPANS``) in the profiler's
    trace while a profiler records; the shared null context otherwise."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir: str, cuda: Optional[bool] = None):
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available() if cuda is None else cuda
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=(
            _ExperimentalConfig(profile_all_threads=True))) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{int(time.time() * 1e3)}.pt.trace.json"))


LAUNCHES: collections.Counter = collections.Counter()


def count_launch(family: str, variant: str, shape) -> None:
    LAUNCHES[family, variant, shape] += 1


def launch_counts(family: str, by_shape: bool = False
                  ) -> collections.Counter:
    """``family``'s launches by variant, or by (variant, shape)."""
    out: collections.Counter = collections.Counter()
    for (fam, variant, shape), n in LAUNCHES.items():
        if fam == family:
            out[(variant, shape) if by_shape else variant] += n
    return out


def reset_launch_counts() -> None:
    LAUNCHES.clear()
