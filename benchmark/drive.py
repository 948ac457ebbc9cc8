"""One run of a cell: what every traffic kind shares.

``run`` makes the inputs from the seed (the raw library and the seeded
weights), preps the library with the program, builds the program's model
from the configuration's flags, and hands a ``Cell`` to the traffic
kind that the mix's data file names (``traffic/<kind>.py``), which sets
up, warms up, runs the measured window and names what the check
compares.  After the window the peak memory is read, the program's state
is freed, and the kind's ``check`` runs the plain reference.

Step boundaries are marked as the loop takes each next batch: CUDA
events on the compute stream (read after the window, so no step
syncs), and host spans around each ``next()`` and each step call.
Every batch the loop takes, in set-up and in the window, passes through
a ``Feed``, which keeps its graph mask and targets: after the window they
name the molecules of each batch (targets are distinct in a library),
from which the graphs and FLOPs of the window are counted and the
reference's batches are taken.  With ``trace``, the kind's
``PROFILE_STEPS`` steps from the window's middle run under
``torch.profiler``, and the gather and BiLSTM launches in them are
recorded with their shapes for the rooflines.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from . import manifest, molecules
from .counts.flops import step_flops
from .reference import common as ref_common
from .reference import for_model
from .reference import prep as ref_prep
from .weights import make_weights

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclasses.dataclass
class Trace:
    """The device side of the profiled steps."""
    steps: int
    span_s: float                   # the profiled span, trace clock
    busy_s: float                   # union of device event intervals
    kernels: int                    # kernel launches
    device_ops: List[list]          # [[name, seconds]] top 10
    idle_gaps: List[list]           # [[host op, seconds]] top 10
    kernel_s: Dict[str, float]      # device seconds by kernel family
    bound_ms: Dict[str, float]      # the families' summed bounds
    bound_n: Dict[str, int]         # launches recorded per family
    event_n: Dict[str, int]         # launches traced per family


@dataclasses.dataclass
class Record:
    """What one run measured; the metric readers read it."""
    setup_s: float = 0.0
    prep_s: float = 0.0
    build_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    steps: int = 0
    graphs: int = 0
    window_s: float = 0.0
    step_ms: List[float] = dataclasses.field(default_factory=list)
    wait_s: List[float] = dataclasses.field(default_factory=list)
    host_s: List[float] = dataclasses.field(default_factory=list)
    flops: float = 0.0
    memory_peak: int = 0            # bytes, the window's peak on the card
    trace: Optional[Trace] = None


class Marks:
    """Step boundaries: CUDA events on the current stream, or the host
    clock on the CPU (where the tests run)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: list = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def intervals_ms(self) -> List[float]:
        m = self.marks
        if self.cuda:
            return [a.elapsed_time(b) for a, b in zip(m, m[1:])]
        return [(b - a) * 1e3 for a, b in zip(m, m[1:])]


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_tf32(on: bool) -> None:
    """TF32 matmuls on or off for cuBLAS and cuDNN (the control's
    precision)."""
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on


class Profiled:
    """``torch.profiler`` over a fixed count of steps, started at the
    first boundary past ``start_at`` (host clock); while on, the gather
    and BiLSTM launches are recorded with their shapes."""

    def __init__(self, device, start_at: float, steps: int):
        self.device, self.start_at, self.steps = device, start_at, steps
        self.prof = None
        self.taken = 0
        self.done = False
        self.launches: List[tuple] = []
        self._undo = []

    def boundary(self):
        if self.done:
            return
        if self.prof is None:
            if time.perf_counter() >= self.start_at:
                self._start()
            return
        self.taken += 1
        if self.taken == self.steps:
            self.stop()

    def _start(self):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._patch()
        self.prof = profile(activities=acts)
        self.prof.start()

    def stop(self):
        if self.prof is None or self.done:
            return
        sync(self.device)
        self.prof.stop()
        self._unpatch()
        self.done = True

    def _patch(self):
        from kpgnn_tpu_torch.ops import lstm, segment, spmm
        rec = self.launches
        k0, f0, b0 = spmm.launch_kernel, lstm.launch_forward, \
            lstm.launch_backward

        def launch_kernel(x, indptr, senders, n_rows, codes=None,
                          table1=None, tablek=None, rows_per_hop=0,
                          hop_live=()):
            ident = segment.identity(senders.shape[0], senders.device)
            rec.append(("gather", dict(
                sorted=senders.data_ptr() == ident.data_ptr(),
                indptr=indptr, senders=senders, codes=codes,
                n_rows=n_rows, n_cols=x.shape[0], D=x.shape[1],
                x_bytes=x.element_size(), rows_per_hop=rows_per_hop)))
            return k0(x, indptr, senders, n_rows, codes, table1, tablek,
                      rows_per_hop, hop_live)

        def launch_forward(xm, w_hh, b_ih, b_hh):
            rec.append(("bilstm", dict(T=xm.shape[0], B=xm.shape[1],
                                       H=w_hh.shape[2],
                                       nbytes=xm.element_size(),
                                       kind="fwd")))
            return f0(xm, w_hh, b_ih, b_hh)

        def launch_backward(dy, y, c, xm, w_hh, b_ih, b_hh):
            rec.append(("bilstm", dict(T=xm.shape[0], B=xm.shape[1],
                                       H=w_hh.shape[2],
                                       nbytes=xm.element_size(),
                                       kind="bwd")))
            return b0(dy, y, c, xm, w_hh, b_ih, b_hh)

        spmm.launch_kernel = launch_kernel
        lstm.launch_forward = launch_forward
        lstm.launch_backward = launch_backward
        self._undo = [(spmm, "launch_kernel", k0),
                      (lstm, "launch_forward", f0),
                      (lstm, "launch_backward", b0)]

    def _unpatch(self):
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo = []


KERNEL_FAMILIES = {"gather": "gather_segment_sum_kernel",
                   "bilstm": "bilstm_"}


def _union(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def read_trace(p: Profiled) -> Trace:
    """The device events of the profiled steps, from the profiler's
    chrome trace; raises when it holds no device event."""
    from .counts.bounds import (kernel_bound_ms, lstm_bound_ms,
                                sorted_sum_bound_ms)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        p.prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    xs = [e for e in events if e.get("ph") == "X" and "dur" in e]
    dev = [e for e in xs if str(e.get("cat", "")).lower() in DEVICE_CATS]
    if not dev:
        raise RuntimeError("the profiler's trace holds no device event: "
                           "no device time to report")
    host = [e for e in xs if str(e.get("cat", "")).lower()
            in ("cpu_op", "user_annotation", "cuda_runtime")]
    t_lo = min(e["ts"] for e in xs)
    t_hi = max(e["ts"] + e["dur"] for e in xs)
    busy = _union([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] * 1e-6
    gaps: Dict[str, float] = {}
    edges = [[t_lo, t_lo]] + busy + [[t_hi, t_hi]]
    h_lo = np.array([e["ts"] for e in host], dtype=np.float64)
    h_hi = h_lo + np.array([e["dur"] for e in host], dtype=np.float64)
    for (_, a), (b, _) in zip(edges, edges[1:]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        inside = np.flatnonzero((h_lo <= mid) & (mid <= h_hi))
        name = (host[inside[np.argmin(h_hi[inside] - h_lo[inside])]]["name"]
                if inside.size else "python (no traced op)")
        gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6
    kernel_s = {f: 0.0 for f in KERNEL_FAMILIES}
    event_n = {f: 0 for f in KERNEL_FAMILIES}
    for e in dev:
        if str(e.get("cat", "")).lower() != "kernel":
            continue
        for fam, key in KERNEL_FAMILIES.items():
            if key in e["name"]:
                kernel_s[fam] += e["dur"] * 1e-6
                event_n[fam] += 1
    bound_ms = {f: 0.0 for f in KERNEL_FAMILIES}
    bound_n = {f: 0 for f in KERNEL_FAMILIES}
    for fam, a in p.launches:
        if fam == "gather":
            if a["sorted"]:
                # the rows a sorted sum reads: [indptr[0], indptr[-1])
                ip = a["indptr"]
                ms, _ = sorted_sum_bound_ms(a["n_rows"],
                                            int(ip[-1]) - int(ip[0]),
                                            a["D"], a["x_bytes"])
            else:
                ms, _ = kernel_bound_ms(a["indptr"], a["senders"],
                                        a["n_rows"], a["n_cols"], a["D"],
                                        a["x_bytes"], a["codes"],
                                        a["rows_per_hop"])
        else:
            ms, _ = lstm_bound_ms(a["T"], a["B"], a["H"], a["nbytes"],
                                  a["kind"])
        bound_ms[fam] += ms
        bound_n[fam] += 1
    top = lambda d: [[k, v] for k, v in sorted(  # noqa: E731
        d.items(), key=lambda kv: -kv[1])[:10]]
    return Trace(steps=p.taken, span_s=(t_hi - t_lo) * 1e-6,
                 busy_s=sum(e - s for s, e in busy) * 1e-6,
                 kernels=sum(1 for e in dev
                             if str(e.get("cat", "")).lower() == "kernel"),
                 device_ops=top(by_name), idle_gaps=top(gaps),
                 kernel_s=kernel_s, bound_ms=bound_ms, bound_n=bound_n,
                 event_n=event_n)


class Feed:
    """The batch iterable the loop consumes.  Keeps each batch's graph
    mask and targets (``taken``); in the window (``rec`` given) it also
    marks a boundary and times the host's wait at each ``next()``, and
    stops at ``deadline`` (host clock) where one is given."""

    def __init__(self, src, rec: Optional[Record] = None,
                 marks: Optional[Marks] = None, deadline=None,
                 prof: Optional[Profiled] = None):
        self.src, self.rec, self.marks = src, rec, marks
        self.deadline, self.prof = deadline, prof
        self.taken: List[tuple] = []

    def __iter__(self):
        return self

    def __next__(self):
        if self.deadline is not None and \
                time.perf_counter() >= self.deadline:
            raise StopIteration
        if self.marks is not None:
            self.marks.mark()
        t0 = time.perf_counter()
        try:
            b = next(self.src)
        except StopIteration:
            if self.marks is not None:
                self.marks.marks.pop()
            raise
        if self.rec is not None:
            self.rec.wait_s.append(time.perf_counter() - t0)
        self.taken.append((b.graph_mask, b.y))
        if self.prof is not None:
            self.prof.boundary()
        return b


def timed(step, rec: Record):
    """``step`` with a host span around each call."""
    def call(*a, **kw):
        t0 = time.perf_counter()
        out = step(*a, **kw)
        rec.host_s.append(time.perf_counter() - t0)
        return out
    return call


def khop_config(m: dict):
    """The program's k-hop prep settings for the model flags ``m``."""
    from kpgnn_tpu_torch.prep.khop import KHopConfig
    return KHopConfig(K=m["K"], kernel=m["kernel"],
                      max_edge_attr_num=m["max_pe_num"],
                      max_hop_num=m["max_hop_num"],
                      max_edge_type=m["max_edge_type"],
                      max_edge_count=m["max_edge_count"],
                      max_distance_count=m["max_distance_count"],
                      use_rd=m["use_rd"])


def ref_prep_config(m: dict) -> ref_prep.PrepConfig:
    if m["kernel"] != "spd":
        raise NotImplementedError(f"the reference prep has no kernel "
                                  f"{m['kernel']!r}")
    return ref_prep.PrepConfig(
        K=m["K"], max_pe=m["max_pe_num"], max_hop=m["max_hop_num"],
        max_edge_type=m["max_edge_type"],
        max_edge_count=m["max_edge_count"],
        max_distance_count=m["max_distance_count"], use_rd=m["use_rd"])


def program_model(m: dict, device):
    """The program's model for the model flags ``m``: every key is a
    field of the program's ``ModelConfig``."""
    from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
    cfg = ModelConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in m.items()})
    return make_model(cfg).to(device)


def stats(graphs) -> np.ndarray:
    """(G, 1 + K): real nodes and live edges per hop of each prepped
    molecule, for the FLOP count."""
    return np.array([[g.num_nodes] + list((np.asarray(g.edge_attr) > 0)
                                          .sum(0)) for g in graphs])


def inputs(cfg: dict, tr: dict, seed: int, device):
    """What both sides are given: the raw library and the weights.  A
    kind with ``CALIBRATE`` sets the norms' running statistics from the
    reference's batch statistics over that many molecules of the library
    (a trained model's estimates follow its activations; seeded ones
    would let eval-mode activations grow layer by layer)."""
    m = cfg["model"]
    ref = for_model(m["model_name"])
    raw = molecules.generate(cfg["data"]["generator"], tr["library"], seed)
    P0 = make_weights(ref.param_spec(m), seed, device)
    n = getattr(manifest.kind(tr), "CALIBRATE", 0)
    if n:
        ms = raw[:n]
        pc = ref_prep_config(m)
        ref_common.calibrate(ref, P0, ref_common.make_batch(
            ms, [ref_prep.prep(x, pc) for x in ms], device), m)
    return raw, P0


def target_key(v) -> int:
    """A float32 target as the integer of its bits."""
    return int(np.float32(v).view(np.uint32))


@dataclasses.dataclass
class Cell:
    """One run's state, handed to the traffic kind."""
    cfg: dict
    tr: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float
    log: Callable
    rec: Record
    raw: list
    P0: Dict[str, torch.Tensor]
    graphs: list
    stats: np.ndarray
    model: torch.nn.Module
    loader_kw: dict
    marks: Marks
    feeds: List[Feed] = dataclasses.field(default_factory=list)
    window_feeds: List[Feed] = dataclasses.field(default_factory=list)
    prof: Optional[Profiled] = None
    t_win: float = 0.0

    @property
    def m(self) -> dict:
        return self.cfg["model"]

    def feed(self, src) -> Feed:
        """A set-up feed over ``src``."""
        f = Feed(src)
        self.feeds.append(f)
        return f

    def open_window(self) -> None:
        """Set-up ends: sync, the peak's count starts, the host clock
        marks the window's start, and the profiler waits for its
        middle."""
        sync(self.device)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        self.t_win = time.perf_counter()
        self.rec.setup_s = self.t_win - self.t_start
        if self.trace:
            self.prof = Profiled(self.device, self.t_win + self.seconds / 2,
                                 manifest.kind(self.tr).PROFILE_STEPS)

    def window_feed(self, src, deadline=True) -> Feed:
        """A window feed over ``src``: boundaries, waits, the profiler;
        it stops at the window's end with ``deadline``."""
        f = Feed(src, self.rec, self.marks,
                 self.t_win + self.seconds if deadline else None, self.prof)
        self.feeds.append(f)
        self.window_feeds.append(f)
        return f

    def in_window(self) -> bool:
        return time.perf_counter() < self.t_win + self.seconds

    def close_window(self, train: bool) -> None:
        """The window ends after its last step: one more boundary, a
        sync; its graphs and FLOPs from the molecules its batches
        held."""
        self.marks.mark()
        sync(self.device)
        rec = self.rec
        rec.window_s = time.perf_counter() - self.t_win
        rec.steps = len(rec.host_s)
        rec.memory_peak = (torch.cuda.max_memory_allocated(self.device)
                           if self.device.type == "cuda" else 0)
        if self.prof is not None:
            self.prof.stop()
        rec.step_ms = self.marks.intervals_ms()
        for mask, ids in self.molecules(self.window_feeds):
            rec.graphs += int(mask.sum())
            known = ids[ids >= 0]
            s = self.stats[known].sum(0)
            rec.flops += step_flops(self.m, int(s[0]), len(known), s[1:],
                                    train)

    def molecules(self, feeds: List[Feed]) -> List[tuple]:
        """(graph mask, molecule of each real graph, -1 for a target
        that names none) of each batch the feeds handed over, in
        order."""
        taken = [t for f in feeds for t in f.taken]
        if not taken:
            return []
        cut = np.cumsum([t[0].shape[0] for t in taken])[:-1]
        masks = np.split(torch.cat([t[0] for t in taken]).cpu().numpy(),
                         cut)
        ys = np.split(torch.cat([t[1].reshape(t[1].shape[0], -1)[:, 0]
                                 for t in taken]).float().cpu().numpy(), cut)
        index = {target_key(m["y"][0]): i for i, m in enumerate(self.raw)}
        return [(mask, np.array([index.get(target_key(v), -1)
                                 for v in y[mask]], np.int64))
                for mask, y in zip(masks, ys)]

    def shortfall(self) -> float:
        """Molecules missing from the batches of the whole run against
        what the loader promises: each epoch's batches partition the
        library, ``batch_size`` distinct molecules each, the last the
        rest."""
        n, bs = len(self.raw), self.tr["batch_size"]
        per_epoch = math.ceil(n / bs)
        short = 0
        for i, (_, ids) in enumerate(self.molecules(self.feeds)):
            j = i % per_epoch
            want = min(bs, n - j * bs)
            short += want - len(set(ids[ids >= 0].tolist()))
        return float(short)


@dataclasses.dataclass
class Run:
    record: Record
    numbers: Dict[str, float]
    trace_error: Optional[str] = None
    notes: List[str] = dataclasses.field(default_factory=list)


def run(cfg: dict, tr: dict, seed: int, seconds: float, trace: bool,
        device, t_start: float, log=print) -> Run:
    """One run of a cell with configuration ``cfg`` and traffic ``tr``;
    ``t_start`` is the process's start on the host clock."""
    from kpgnn_tpu_torch.ops import cuda_lib
    from kpgnn_tpu_torch.prep.runner import preprocess_graphs
    from kpgnn_tpu_torch.scripts.common import set_full_f32

    device = torch.device(device)
    kind = manifest.kind(tr)
    m = cfg["model"]
    rec = Record()
    set_full_f32()
    if device.type == "cuda":
        rec.build_s = cuda_lib.build_all(["gather_segment_sum.cu",
                                          "bilstm.cu"])
        log(f"nvcc seconds {json.dumps(rec.build_s)}")
    raw, P0 = inputs(cfg, tr, seed, device)
    t0 = time.perf_counter()
    graphs = preprocess_graphs(raw, khop_config(m))
    rec.prep_s = time.perf_counter() - t0
    log(f"prep seconds {rec.prep_s:.4f} for {len(graphs)} molecules")
    model = program_model(m, device)
    model.load_state_dict(P0, strict=True)
    lkw = {"mode": tr["backend"]}
    if tr["backend"] != "coo":
        lkw.update(v1=m["num_hop1_edge"] + 2, vk=m["max_pe_num"] + 2)
    ctx = Cell(cfg=cfg, tr=tr, seed=seed, seconds=seconds, trace=trace,
               device=device, t_start=t_start, log=log, rec=rec, raw=raw,
               P0=P0, graphs=graphs, stats=stats(graphs), model=model,
               loader_kw=lkw, marks=Marks(device))
    got = kind.window(ctx)
    got["short"] = ctx.shortfall()
    out = Run(record=rec, numbers={})
    if ctx.prof is not None:
        if ctx.prof.prof is None:
            out.trace_error = ("the window ended before its middle's "
                               "profiled steps began")
        else:
            try:
                rec.trace = read_trace(ctx.prof)
            except RuntimeError as e:
                out.trace_error = str(e)
    del ctx, model, graphs
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    out.numbers, line = kind.check(cfg, tr, raw, P0, got, device)
    out.numbers["molecules_short"] = got["short"]
    out.notes.append(line)
    return out


# molecules a block of the reference's forward holds
REF_BLOCK = 1024


def ref_forward_all(ref, P, raw, preps, m, device) -> torch.Tensor:
    """The reference's eval-mode predictions of every molecule of
    ``raw``, in blocks of ``REF_BLOCK``."""
    with torch.no_grad():
        return torch.cat([ref.forward(P, ref_common.make_batch(
            raw[i:i + REF_BLOCK], preps[i:i + REF_BLOCK], device), m,
            train=False) for i in range(0, len(raw), REF_BLOCK)])
