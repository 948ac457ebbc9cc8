"""The program's spans in the profiled steps, read from the profiler's
chrome trace.

The port marks its layers with spans (``utils/profiling.span`` in
``kpgnn_tpu_torch``): ``user_annotation`` events on the thread that ran
them, on the clock of the device's events.  The dispatching thread is
the one that holds the ``loop.step`` spans; the loader's collates and
the prefetch thread's copies run on threads of their own.
``summarize(events)`` gives:

* ``steps``: the dispatching thread's ``loop.step`` spans;
* ``spans``: {name: [count, seconds]} of every program span;
* ``idle_by_span``: each device-idle gap (the complement of the union of
  the device's kernel, memcpy and memset intervals over the trace's
  span, as ``device.idle_share`` takes it) goes to the innermost span of
  the dispatching thread that holds its midpoint, or to ``(no span)``:
  {name: [seconds, {innermost span of another thread at the midpoint:
  seconds}]};
* ``metrics``: the values the per-layer metrics of these spans read,
  each None where its span is absent:

  - ``input.collate_ms``, ``input.copy_ms``: the mean ms of a
    ``loader.collate`` / ``prefetch.copy`` span;
  - ``step.forward_ms``, ``step.backward_ms``, ``step.optimizer_ms``:
    the summed ms of the phase's spans over the steps;
  - ``device.idle_in_step_ms``: the device-idle ms inside the steps'
    spans, over the steps;
  - ``model.pool_device_share``: the device time of the events launched
    inside a ``model.pool`` span, in percent of the device's busy time.
    A device event is matched to its launch, the CUDA runtime call of
    the same ``correlation`` id, which must lie inside the span on the
    span's thread: the backward's launches come from the autograd
    engine's thread, so this counts the forward's.
"""
from __future__ import annotations

from collections import Counter, defaultdict
from typing import Dict, List, Optional

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
PROGRAM = ("loop.", "step.", "model.", "layer.", "loader.", "prefetch.")
NO_SPAN = "(no span)"


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _innermost(spans, t) -> Optional[str]:
    """The name of the shortest span of ``spans`` that holds ``t``."""
    best = None
    for name, s, e in spans:
        if s <= t <= e and (best is None or e - s < best[1]):
            best = (name, e - s)
    return None if best is None else best[0]


def summarize(events: List[dict]) -> dict:
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    by_tid: Dict[object, list] = defaultdict(list)
    for e in xs:
        if e.get("cat") == "user_annotation" \
                and e["name"].startswith(PROGRAM):
            by_tid[e["tid"]].append((e["name"], e["ts"], e["ts"] + e["dur"]))
    n_step = Counter({t: sum(n == "loop.step" for n, _, _ in sp)
                      for t, sp in by_tid.items()})
    main = n_step.most_common(1)[0][0] if n_step else None
    steps = n_step[main] if main is not None else 0
    spans: Dict[str, list] = {}
    for sp in by_tid.values():
        for name, s, e in sp:
            v = spans.setdefault(name, [0, 0.0])
            v[0] += 1
            v[1] += (e - s) * 1e-6
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS]
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    busy_us = sum(e - s for s, e in busy)
    gaps = []
    if xs:
        t_lo = min(e["ts"] for e in xs)
        t_hi = max(e["ts"] + e["dur"] for e in xs)
        edges = [[t_lo, t_lo]] + busy + [[t_hi, t_hi]]
        gaps = [(a, b) for (_, a), (b, _) in zip(edges, edges[1:]) if b > a]
    main_spans = by_tid.get(main, [])
    idle: Dict[str, list] = {}
    for a, b in gaps:
        mid = 0.5 * (a + b)
        row = idle.setdefault(_innermost(main_spans, mid) or NO_SPAN,
                              [0.0, {}])
        row[0] += (b - a) * 1e-6
        for tid, sp in by_tid.items():
            other = _innermost(sp, mid) if tid != main else None
            if other is not None:
                row[1][other] = row[1].get(other, 0.0) + (b - a) * 1e-6
    step_iv = [(s, e) for n, s, e in main_spans if n == "loop.step"]
    idle_in_step = sum(max(0.0, min(b, e) - max(a, s))
                       for a, b in gaps for s, e in step_iv)

    def mean_ms(name):
        v = spans.get(name)
        return 1e3 * v[1] / v[0] if v else None

    def per_step_ms(name):
        total = sum(e - s for n, s, e in main_spans if n == name)
        return 1e-3 * total / steps if steps and name in spans else None

    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    pools = [(t, s, e) for t, sp in by_tid.items()
             for n, s, e in sp if n == "model.pool"]
    pool_us = 0.0
    for e in dev:
        at = launch.get((e.get("args") or {}).get("correlation"))
        if at is not None and any(t == at[0] and s <= at[1] <= f
                                  for t, s, f in pools):
            pool_us += e["dur"]
    metrics = {
        "input.collate_ms": mean_ms("loader.collate"),
        "input.copy_ms": mean_ms("prefetch.copy"),
        "step.forward_ms": per_step_ms("step.forward"),
        "step.backward_ms": per_step_ms("step.backward"),
        "step.optimizer_ms": per_step_ms("step.optimizer"),
        "device.idle_in_step_ms": (1e-3 * idle_in_step / steps
                                   if steps else None),
        "model.pool_device_share": (100.0 * pool_us / busy_us
                                    if pools and busy_us > 0 else None),
    }
    return {"steps": steps, "spans": spans, "idle_by_span": idle,
            "metrics": metrics}
