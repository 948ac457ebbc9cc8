"""Profile the flagship training step on the card (counterpart of
kpgnn_tpu/scripts/profile_step.py).

Answers "where does the step time go" in five regimes:

  * ``resident``    — the flagship KPGINPlus (K=8 L=8 H=104) dense
    resident epoch: its steady-state time, then a torch.profiler trace of
    one epoch and its top device-time ops;
  * ``resident_ab`` — the same epoch in f32 and in bf16, steady state;
  * ``bf16``        — one dense train step, f32 against bf16, each with a
    trace of 10 steps;
  * ``large``       — KPGIN K=3 H=102 L=3 on two 8,192-node polymers
    (``synthetic_polymers``) through the kernel plan (``collate_pallas``,
    whose host seconds it prints): the step time and a trace of 5 steps;
  * ``banded``      — the same model on the same graphs through the
    banded plan (``collate_banded``; its tile, halo and spill printed),
    the step in f32 and in bf16, each with a trace of 5 steps.

Each stage prints its time and
``utils.trace_summary.report`` of its trace (under ``--out_dir``).  A
stage that fails is reported with its traceback and the other stages
still run; the process then exits with status 1.  ``--device`` defaults
to cuda (without CUDA it raises unless ``--device cpu`` is given).

    python -m kpgnn_tpu_torch.scripts.profile_step --stages resident,bf16,large
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time
import traceback
from typing import Callable, Dict

import torch

from ..data.synthetic import synthetic_molecules, synthetic_polymers
from ..graph.batch import collate_banded, collate_dense, collate_pallas
from ..models.factory import ModelConfig, make_model
from ..nn.inits import init_parameters
from ..prep.khop import KHopConfig
from ..train.loop import resolve_device, train_step
from ..train.resident import (build_dense_store, epoch_index_chunks,
                              make_resident_train_epoch)
from ..train.state import make_optimizer
from ..utils.profiling import trace
from ..utils.trace_summary import report
from .common import set_full_f32

K, L, HIDDEN, BATCH = 8, 8, 104, 64
N_SLOT = 40
LARGE_NODES, LARGE_GRAPHS, LARGE_K, LARGE_L, LARGE_HIDDEN = 8192, 2, 3, 3, 102
REPEATS = 3             # timed rounds; the best is reported
STEP_ITERS = 20         # dense steps a round (eager steps take ~100 ms)
LARGE_ITERS = 20        # large-graph steps a round
TOP_N = 30


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _flagship(dtype="float32"):
    kcfg = KHopConfig(K=K, kernel="spd", max_edge_attr_num=30,
                      max_hop_num=6, max_edge_type=3, max_edge_count=20,
                      max_distance_count=30)
    graphs = synthetic_molecules(4 * BATCH, kcfg, seed=0)
    mcfg = ModelConfig(
        model_name="KPGINPlus", hidden_size=HIDDEN, num_layer=L, K=K,
        num_hop1_edge=3, max_pe_num=30, max_edge_type=3,
        max_edge_count=20, max_hop_num=6, max_distance_count=30,
        JK="concat", combine="attention", residual=True,
        input_encoder=("embedding", 21), task="graph_regression",
        pooling_method="sum", compute_dtype=dtype)
    return mcfg, graphs


def _model(mcfg, device):
    model = init_parameters(make_model(mcfg), 0).to(device)
    return model, make_optimizer(model.parameters(), 1e-3)


def _best(fn: Callable, iters: int, device) -> float:
    """Best seconds per call of ``fn`` over REPEATS rounds of ``iters``
    calls, each round ending in a device sync."""
    best = float("inf")
    for _ in range(REPEATS):
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _traced(out_dir, label, fn, device, calls=1) -> str:
    """``calls`` calls of ``fn`` under the profiler into out_dir/label;
    prints and returns the trace's report."""
    d = os.path.join(out_dir, label.split(" ")[0])
    with trace(d, cuda=device.type == "cuda"):
        for _ in range(calls):
            fn()
    text = report(d, TOP_N)
    print(f"\n==== trace summary: {label} ====\n{text}", flush=True)
    return text


def _resident_epoch(dtype, device):
    mcfg, graphs = _flagship(dtype)
    v1, vk = mcfg.num_hop1_edge + 2, mcfg.max_pe_num + 2
    store = build_dense_store(graphs, N_SLOT, v1, vk, device=device)
    chunks = epoch_index_chunks(torch.arange(len(graphs)).numpy(), BATCH,
                                store.num_graphs)
    model, opt = _model(mcfg, device)
    ep = make_resident_train_epoch(model, opt, loss="l1")
    gen = torch.Generator(device=device).manual_seed(1)
    return (lambda: ep(store, chunks, gen)), len(chunks)


def stage_resident(out_dir, device):
    epoch, steps = _resident_epoch("float32", device)
    epoch()                                             # warm-up
    dt = _best(epoch, 1, device)
    print(f"resident epoch steady-state: {dt * 1e3:.1f} ms ({steps} steps "
          f"of batch {BATCH})", flush=True)
    _traced(out_dir, "resident epoch (flagship KPGINPlus K=8 L=8 h=104)",
            epoch, device)
    return dt


def stage_resident_ab(out_dir, device):
    """Resident-epoch A/B: f32 against bf16 activations, steady state."""
    out = {}
    for dtype in ("float32", "bfloat16"):
        epoch, steps = _resident_epoch(dtype, device)
        loss = epoch()[0]
        out[dtype] = _best(epoch, 1, device)
        print(f"resident {dtype} epoch: {out[dtype] * 1e3:.2f} ms ({steps} "
              f"steps, first epoch loss {loss:.4f})", flush=True)
        _traced(out_dir, f"resident_{dtype} epoch", epoch, device)
    return out


def stage_bf16(out_dir, device):
    mcfg, graphs = _flagship()
    v1, vk = mcfg.num_hop1_edge + 2, mcfg.max_pe_num + 2
    batches = [collate_dense(graphs[i:i + BATCH], n_slot=N_SLOT, v1=v1,
                             vk=vk, g_pad=BATCH).to(device)
               for i in range(0, len(graphs), BATCH)]
    out = {}
    for dtype in ("float32", "bfloat16"):
        model, opt = _model(_flagship(dtype)[0], device)
        i = [0]

        def step():
            train_step(model, opt, batches[i[0] % len(batches)])
            i[0] += 1
        for _ in batches:
            step()
        out[dtype] = _best(step, STEP_ITERS, device)
        print(f"dense {dtype} step: {out[dtype] * 1e3:.3f} ms", flush=True)
        _traced(out_dir, f"step_{dtype} dense single step x10", step,
                device, calls=10)
    return out


def large_config(dtype: str = "float32") -> ModelConfig:
    """KPGIN K=3 H=102 L=3, attention combine: the large stages' model."""
    return ModelConfig(
        model_name="KPGIN", hidden_size=LARGE_HIDDEN, num_layer=LARGE_L,
        K=LARGE_K, num_hop1_edge=3, max_pe_num=30, max_edge_type=3,
        max_edge_count=20, max_hop_num=6, max_distance_count=30,
        JK="last", combine="attention", residual=True,
        input_encoder=("embedding", 21), task="graph_regression",
        pooling_method="sum", compute_dtype=dtype)


def large_batch(collate_fn: Callable = collate_pallas):
    """(model config, collated batch, collate seconds) of the large
    stages: LARGE_GRAPHS polymers of LARGE_NODES nodes, collated on the
    host by ``collate_fn`` (the kernel plan, or ``collate_banded``)."""
    graphs = synthetic_polymers(LARGE_GRAPHS, LARGE_NODES, K=LARGE_K, seed=0)
    mcfg = large_config()
    t0 = time.perf_counter()
    b = collate_fn(graphs, v1=mcfg.num_hop1_edge + 2,
                   vk=mcfg.max_pe_num + 2)
    return mcfg, b, time.perf_counter() - t0


def stage_large(out_dir, device):
    mcfg, b, collate_s = large_batch()
    print(f"large-graph collate_pallas (host): {collate_s:.3f} s for "
          f"{LARGE_GRAPHS} x {LARGE_NODES} nodes, K={LARGE_K}; "
          f"{b.adj.fwd.senders.shape[0]} hop edges over "
          f"{b.adj.fwd.n_rows} rows", flush=True)
    b = b.to(device)
    model, opt = _model(mcfg, device)

    def step():
        train_step(model, opt, b)
    step()
    dt = _best(step, LARGE_ITERS, device)
    print(f"large-graph pallas step: {dt * 1e3:.3f} ms", flush=True)
    _traced(out_dir, f"large_pallas step (n={LARGE_NODES} x{LARGE_GRAPHS}, "
            f"K={LARGE_K}) x5", step, device, calls=5)
    return {"collate_s": collate_s, "step_s": dt}


def stage_banded(out_dir, device):
    """The large stage's model and graphs on the banded plan, f32 and
    bf16."""
    _, b, collate_s = large_batch(collate_banded)
    adj = b.adj
    spill = 0 if adj.spill_senders is None else adj.spill_senders.shape[0]
    print(f"banded plan: tile={adj.tile}, halo={adj.halo}, spill={spill}; "
          f"n_pad {b.n_pad}, collate_banded (host) {collate_s:.3f} s",
          flush=True)
    b = b.to(device)
    out = {"collate_s": collate_s}
    for dtype in ("float32", "bfloat16"):
        model, opt = _model(large_config(dtype), device)

        def step():
            train_step(model, opt, b)
        step()
        out[dtype] = _best(step, LARGE_ITERS, device)
        print(f"banded {dtype} step: {out[dtype] * 1e3:.3f} ms", flush=True)
        _traced(out_dir, f"banded_{dtype} large step (n={LARGE_NODES} "
                f"x{LARGE_GRAPHS}, K={LARGE_K}) x5", step, device, calls=5)
    return out


STAGES: Dict[str, Callable] = {
    "resident": stage_resident, "resident_ab": stage_resident_ab,
    "bf16": stage_bf16, "large": stage_large, "banded": stage_banded}


def main(argv=None):
    """Runs the stages; returns {stage: its times}.  Exits with status 1
    after the last stage if any stage failed."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out_dir", default=None,
                   help="where the traces go (default: a new temporary "
                        "directory)")
    p.add_argument("--stages", default="resident,bf16,large")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA the run raises unless "
                        "--device cpu is given")
    args = p.parse_args(argv)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        p.error(f"unknown stages {unknown}; choose from {sorted(STAGES)}")
    device = resolve_device(args.device)
    set_full_f32()
    out_dir = args.out_dir or tempfile.mkdtemp(prefix="kpgnn_profile_")
    os.makedirs(out_dir, exist_ok=True)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {device} ({name}); traces under {out_dir}", flush=True)
    results, failed = {}, []
    for stage in stages:
        print(f"\n######## stage {stage} ########", flush=True)
        t0 = time.time()
        try:
            results[stage] = STAGES[stage](out_dir, device)
        except Exception:
            traceback.print_exc()
            failed.append(stage)
        print(f"[stage {stage} {'FAILED' if stage in failed else 'done'} "
              f"in {time.time() - t0:.1f}s]", flush=True)
    if failed:
        print(f"profile_step: stages failed: {', '.join(failed)}", flush=True)
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
