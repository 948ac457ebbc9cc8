"""Summarize a profiler chrome trace: top ops by device time (counterpart
of kpgnn_tpu/utils/trace_summary.py).

``--profile_dir`` (utils/profiling.py) captures a trace of one training
epoch; this module answers "where did the step time go" without
TensorBoard.  It reads the ``*.pt.trace.json`` files torch.profiler
writes (gzipped or not), and the JAX package's ``*.trace.json.gz``
layout, so one ranking serves both.

Complete ('X') events carry ``dur`` in microseconds.  In a torch.profiler
trace every event has a ``cat``: the device's events are ``kernel``,
``gpu_memcpy`` and ``gpu_memset``, on the track ``/device:GPU:<device>``;
every other event (operators, Python functions, CUDA runtime calls) is on
``/host:CPU``.  Events without a ``cat`` (the JAX layout) take their
track from the ``process_name`` metadata of their pid, and a track is a
device track unless its name starts with ``/host``.  Kernels on one
stream do not overlap, so summing durations by name attributes the
device's busy time.

The program's spans (``utils.profiling.span``: ``user_annotation``
events) are listed beside the top ops: their count, their host time and
the device time of the kernels, copies and sets launched inside them.  A
device event is matched to its launch (the CUDA runtime call of the same
``correlation`` id) and counts toward every span that holds the launch
on the launching thread.  The autograd engine launches a backward's
kernels from a thread of its own that holds no span: their time is
reported as launched outside every span.

CLI: ``python -m kpgnn_tpu_torch.utils.trace_summary <logdir-or-trace>
[top_n]``
"""
from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np

TRACE_PATTERNS = ("*.pt.trace.json", "*.pt.trace.json.gz", "*.trace.json.gz",
                  "*.json", "*.json.gz")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def find_trace(path: str) -> str:
    """``path`` may be the trace file itself, a profile logdir, or any
    ancestor of one; returns the newest trace file below it."""
    if os.path.isfile(path):
        return path
    hits = {h for pat in TRACE_PATTERNS
            for h in glob.glob(os.path.join(path, "**", pat), recursive=True)}
    if not hits:
        raise FileNotFoundError(f"no chrome trace ({', '.join(TRACE_PATTERNS)})"
                                f" under {path}")
    return max(hits, key=os.path.getmtime)


def load_events(trace_file: str) -> List[dict]:
    opener = gzip.open if trace_file.endswith(".gz") else open
    with opener(trace_file, "rt") as f:
        return json.load(f).get("traceEvents", [])


def _base_name(name: str) -> str:
    """Collapse uniquifying suffixes: 'fusion.123' -> 'fusion',
    'dynamic-update-slice.5' -> 'dynamic-update-slice'."""
    head, _, tail = name.rpartition(".")
    return head if head and tail.isdigit() else name


def _track(e: dict, proc: Dict[object, str]) -> str:
    cat = e.get("cat")
    if cat is None:
        return proc.get(e.get("pid"), f"pid:{e.get('pid')}")
    if str(cat).lower() in DEVICE_CATS:
        device = (e.get("args") or {}).get("device", e.get("pid"))
        return f"/device:GPU:{device}"
    return "/host:CPU"


def summarize(events: List[dict]) -> Dict[str, dict]:
    """Per-track summary: {track_name: {total_us, ops: {name: us},
    count, counts: {name: events}}}."""
    proc = {e["pid"]: e["args"]["name"] for e in events
            if e.get("ph") == "M" and e.get("name") == "process_name"}
    tracks: Dict[str, dict] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        t = tracks.setdefault(_track(e, proc), {
            "total_us": 0.0, "ops": defaultdict(float), "count": 0,
            "counts": defaultdict(int)})
        name = _base_name(e["name"])
        t["total_us"] += e["dur"]
        t["ops"][name] += e["dur"]
        t["count"] += 1
        t["counts"][name] += 1
    return tracks


def top_ops(tracks: Dict[str, dict], device_only: bool = True,
            n: int = 25) -> List[Tuple[str, float, float]]:
    """[(op, us, fraction-of-total)] over the device tracks (every track
    without ``device_only``)."""
    agg: Dict[str, float] = defaultdict(float)
    total = 0.0
    for name, t in tracks.items():
        if device_only and name.startswith("/host"):
            continue
        for op, us in t["ops"].items():
            agg[op] += us
        total += t["total_us"]
    ranked = sorted(agg.items(), key=lambda kv: -kv[1])[:n]
    return [(op, us, us / total if total else 0.0) for op, us in ranked]


def span_summary(events: List[dict]) -> Tuple[Dict[str, dict], float]:
    """({span name: {"count", "host_us", "device_us"}}, the device us
    launched outside every span) of a torch.profiler trace; ({}, 0.0)
    where it holds no span."""
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    spans = [e for e in xs if e.get("cat") == "user_annotation"]
    launch = {e["args"]["correlation"]: (e["tid"], e["ts"]) for e in xs
              if e.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in (e.get("args") or {})}
    dev = [(launch.get((e.get("args") or {}).get("correlation"),
                       ("", np.nan)), e["dur"]) for e in xs
           if str(e.get("cat", "")).lower() in DEVICE_CATS]
    out: Dict[str, dict] = {}
    by_track: Dict[tuple, list] = defaultdict(list)
    for e in spans:
        s = out.setdefault(e["name"], {"count": 0, "host_us": 0.0,
                                       "device_us": 0.0})
        s["count"] += 1
        s["host_us"] += e["dur"]
        by_track[e["tid"], e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    inside = np.zeros(len(dev), bool)
    tid = np.array([str(t) for (t, _), _ in dev])
    ts = np.array([t for (_, t), _ in dev], np.float64)
    dur = np.array([d for _, d in dev], np.float64)
    for (t, name), iv in by_track.items():
        iv.sort()
        lo, hi = (np.array(a, np.float64) for a in zip(*iv))
        k = np.searchsorted(lo, ts, side="right") - 1
        hit = (tid == str(t)) & (k >= 0) & (ts <= hi[np.maximum(k, 0)])
        out[name]["device_us"] += float(dur[hit].sum())
        inside |= hit
    return out, float(dur[~inside].sum())


def report(path: str, n: int = 25) -> str:
    trace = find_trace(path)
    events = load_events(trace)
    tracks = summarize(events)
    lines = [f"trace: {trace}"]
    for name in sorted(tracks, key=lambda k: -tracks[k]["total_us"]):
        t = tracks[name]
        lines.append(f"track {name}: {t['total_us'] / 1e3:.2f} ms busy, "
                     f"{t['count']} events")
    device = [k for k in tracks if not k.startswith("/host")]
    rows = top_ops(tracks, device_only=bool(device), n=n)
    scope = "device" if device else "host (no device track in trace)"
    lines.append(f"top ops by {scope} time:")
    for op, us, frac in rows:
        lines.append(f"  {us / 1e3:9.3f} ms  {frac * 100:5.1f}%  {op}")
    spans, outside = span_summary(events)
    if spans:
        lines.append("spans: count, host ms, device ms launched "
                     "inside:")
        for name in sorted(spans, key=lambda k: -spans[k]["host_us"]):
            s = spans[name]
            lines.append(f"  {s['count']:6d}  {s['host_us'] / 1e3:9.3f} ms "
                         f" {s['device_us'] / 1e3:9.3f} ms  {name}")
        lines.append(f"  device ms launched outside every span: "
                     f"{outside / 1e3:.3f}")
    return "\n".join(lines)


def main(argv=None):
    import sys
    args = list(sys.argv[1:] if argv is None else argv)
    if not args:
        raise SystemExit("usage: trace_summary <logdir-or-trace> [top_n]")
    n = int(args[1]) if len(args) > 1 else 25
    print(report(args[0], n))


if __name__ == "__main__":
    main()
