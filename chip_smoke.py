#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kpgnn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:
  1. build  — compile every CUDA kernel of the main path from this
     checkout's sources (csrc/, nvcc for sm_90a); print the card, its power
     limit, each source's build hash and the build seconds;
  2. check  — hold each kernel variant against its plain PyTorch version on
     the card, forward and autograd backward.  The gather: flagship plans
     (64 ZINC-shaped molecules, K=8, D=104, every hop prefix k=1..8) and
     edge cases (empty rows with null senders, a 10k-edge hub row, a
     rectangular table at D=64, D=13, bf16 input, an x whose data_ptr is
     not 16-byte aligned).  The fused gather + edge-embedding term at every
     hop prefix k=1..8, with autograd grads of x and both tables, and at
     k=8 in bf16, misaligned and D=13.  Together these take the 16-byte and
     the scalar variant in each direction.  Then three repeated launches of
     every variant on one input must be bit-identical (the gather over the
     backward CSR, the fused form over the forward one, as the main path
     runs them);
  3. train  — write a ZINC-format fixture (tools/make_zinc_fixture.py) and
     run ``kpgnn_tpu_torch.scripts.train_zinc.main`` at the flagship's
     full width (KPGINPlus K=8 L=8 H=104, attention combine, JK concat,
     residual, --backend pallas) for one epoch; require finite losses,
     exactly 2*L kernel launches per train step (L fused forward, L
     gather backward) plus L per eval step, and a first-step loss equal to
     the same step on the CPU and to the same step on --backend coo on the
     card;
  4. csl    — run ``kpgnn_tpu_torch.scripts.train_csl.main`` at the
     reference width (KPGIN on GNN, K=4 L=4 H=48, batch 64, --backend
     pallas, fold 0 of the 10-fold split, 2 epochs): finite losses,
     exactly 2*L launches per train step and L per eval step, and a
     first-step loss equal to the CPU's and to --backend coo's on the
     card.  The kernel is also checked at the CSL shapes (D=12 over the
     k=4 plan, D=48 over its hop-1 slice, the GINE layers');
  5. families — one AdamW step of KPGCN, KPGraphSAGE (mean) and
     KPGINPrime (one K-hop layer, then GINE) at CSL width on a CSL batch,
     through the kernel: loss and every parameter gradient against the
     same step on the CPU, and each family's launches per variant (KPGCN:
     the plain gather after its sender pre-scale, L forward + L backward;
     the others L fused forward + L gather backward);
  6. qm9    — write a qm9_v3.pt-format fixture (tools/make_qm9_fixture.py,
     640 molecules, seed 7) and run ``kpgnn_tpu_torch.scripts.train_qm9
     .main`` at the canonical width (KPGINPlus K=8 L=8 H=128, batch 128,
     attention combine and pooling, --virtual_node --use_rd, task 0,
     --backend pallas, 2 epochs): finite losses, exactly 2*L launches per
     train step and L per eval step, and a first-step loss equal to the
     CPU's, to --backend coo's on the card and to --backend dense's on the
     card; then one Adam step of the same config against the CPU under
     the gradient gate (below).  The kernel is checked at its QM9 shapes
     (D=128 over the k=8 plan; D=8 over the k=16 plan and D=128 over its
     hop-1 slice, the sweep's KPGINPrime K=16 L=16);
  7. dense  — ``train_qm9.main --dense`` on the card for the same 2 epochs:
     finite losses, no kernel launch, and the pallas run's first-step
     loss; then one Adam step of the sweep's second config (KPGINPrime
     K=16 L=16 --residual --use_rd, the one main path whose K-hop layer
     launches at the kernel's 16 hops) against the CPU under the
     gradient gate, with its launches per width;
  8. generated — run each generated-data script's ``main`` at its
     canonical width for 2 epochs on --backend pallas: ``train_counting``
     (KPGINPlus K=3 L=3 H=96, batch 64, 1000 graphs, task 0),
     ``train_node_property`` (KPGINPlus K=6 L=6 H=128, batch 128, node
     regression head, --data_scale 0.1, task 0), ``train_graph_property``
     (K=6 L=6 H=96, batch 128, --data_scale 0.1, task 1) and ``train_tu``
     (KPGIN on GNN, K=2 L=3 H=32, batch 32, fold 0 of a generated
     MUTAG-scale GIN-format fixture, ``write_gin_fixture``; dropout 0,
     since the CPU's and the card's generators draw different masks):
     finite losses, exactly 2*L launches per train step and L per eval
     step, and a first-step loss equal to the CPU's, to --backend coo's
     and to --backend dense's on the card; then one Adam step of the
     node-property config against the CPU under the gradient gate (the
     node head and the node-level loss).  The kernel is checked at their
     shapes (K=3 D=96, K=6 D=128, K=6 D=96, K=2 D=16, each over its
     first batch's plan) in phase 2;
  9. time   — on the flagship k=8 plan (CUDA events, after warm-up,
     rotating distinct inputs), each beside the least time the card could
     take: every kernel variant on the CSR where the main path launches it
     (the gather over the backward CSR, the fused form over the forward
     one), its plain version and, for the gather, one ``torch.sparse.mm``
     call; the gather over the forward CSR likewise; the unfused
     composition the fused forward replaces (kernel + k ``counts @ table``
     GEMMs + stack + add); and the flagship train step, with its device
     time by kernel from torch.profiler.  Then the same kernel times at
     the CSL shapes, KPGCN's whole aggregation (sender pre-scale, gather,
     weighted histograms, K GEMMs, receiver scale) at D=12, the host's
     collate time per CSL batch, and the CSL train step with its profile;
     the kernel times at the QM9 shapes, and the QM9 train step on pallas
     and on dense, each with its profile; the kernel times at the four
     generated-data shapes, and the node-property train step with its
     profile.
The last lines are the card's name and power limit, a ``kernels`` JSON
line, and ``{"ok": true, "device": {...}}``.  The ``kernels`` line has one
entry per kernel variant, timed on the flagship plan, with the launches
of every run at every width; then one entry per variant and main-path
shape (the flagship's D=104, CSL's D=12 over the k=4 plan, GINE's D=48
over its hop-1 slice, QM9's D=128 over the k=8 plan, KPGINPrime-QM9's D=8
over the k=16 plan and D=128 over its hop-1 slice, counting's D=96 over
the k=3 plan, node property's D=128 and graph property's D=96 over
their k=6 plans, TU's D=16 over the k=2 plan), each with the launches
of the run that takes that shape, its error, times and bound.

Tolerances: f32 gather vs plain version atol 1e-5, except the hub row,
whose 10k-term sums may differ in summation order by up to 1e-6 of the
row's sum of |x| (plus 1e-5); the fused forward likewise 1e-5 plus 1e-6
of its sum of |terms| (the kernel adds x and table rows edge by edge,
the plain version per edge pair); the table gradients, sums over the n
rows of the counts (a matmul against an atomic scatter in varying
order), 1e-5 plus 2*sqrt(n)*2**-24 of their sum of |terms|, the
probabilistic bound of f32 summation error; bf16 input vs the plain
version on the same bf16 values, both summed in f32, rtol 1e-3; first
train-step loss GPU vs CPU, and kernel vs COO backend on the card, rtol
1e-4 (on the card the COO backend's index_add_ sums with atomics, in an
order that varies from run to run, so neither side is bitwise fixed);
gradient gate (the family steps, the QM9 step, KPGINPrime K=16 L=16,
the node-property step),
one step on the card against the same step on the CPU: the loss rtol
1e-4; every parameter gradient, against the CPU step that takes the
card's ReLU branches, rtol 1e-4 and an atol of 1e-4 of that parameter's
largest gradient, plus 8 times its f32 rounding, measured as how far its
CPU gradient moves when every weight moves by an ulp (w * (1 +- 2**-23)),
plus 1e-7 of the model's largest gradient.  A gradient that is 0 in
exact arithmetic (a bias ahead of a batch norm) is all rounding, and a
sum that cancels (a scalar gate) carries more than 1e-4 of itself; the
measured term admits both without widening any other parameter's bound.
ReLU is the gated models' one branch point.  An input the card computes
within its rounding of 0 can land on the other side (in the two QM9
steps 10 or 11 of 9-17M inputs, within ~6e-5 of 0; PERF.md §6), and
every gradient below it then differs by far more than rounding; so the
card's ReLU inputs are recorded and the CPU steps (the ulp-moved one
too) replay their branches (``relu_branches``), and every input whose
branch differs must lie within 1e-4 of its call's largest |input| of 0.
"""
import contextlib
import importlib.util
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.abspath(__file__))
K, L, H, BATCH = 8, 8, 104, 64
N_TRAIN, N_VAL, N_TEST = 1024, 128, 128
SEED = 234
CSL_K, CSL_L, CSL_H, CSL_BATCH, CSL_EPOCHS = 4, 4, 48, 64, 2
QM9_K, QM9_L, QM9_H, QM9_BATCH, QM9_EPOCHS = 8, 8, 128, 128, 2
QM9_MOLECULES, QM9_FIXTURE_SEED = 640, 7
PRIME_K = PRIME_L = 16          # the QM9 sweep's KPGINPrime config
GEN_EPOCHS = 2
# the generated-data scripts at their canonical widths (their defaults):
# label -> (script, data-size arguments, loss, node-level target).  TU
# trains without dropout here: the CPU's and the card's generators draw
# different masks, and the first step is compared across devices
GENERATED = {
    "counting": ("train_counting", ("--n_graphs", "1000", "--task", "0"),
                 "l1", False),
    "nprop": ("train_node_property", ("--data_scale", "0.1", "--task", "0"),
              "mse", True),
    "gprop": ("train_graph_property", ("--data_scale", "0.1", "--task",
                                       "1"), "mse", False),
    "tu": ("train_tu", ("--folds", "1", "--drop_prob", "0"),
           "cross_entropy", False),
}
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM data sheet, f32 outside the MMA
KERNEL = dict(route="cuda",
              source="kpgnn_tpu_torch/csrc/gather_segment_sum.cu",
              replaces="kpgnn_tpu/ops/pallas_spmm.py:159")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


def card_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


def write_fixture(root):
    """ZINC-format raw bundle from tools/make_zinc_fixture.py's molecule
    generator (numpy + torch), at N_TRAIN/N_VAL/N_TEST molecules."""
    path = os.path.join(ROOT, "tools", "make_zinc_fixture.py")
    spec = importlib.util.spec_from_file_location("make_zinc_fixture", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    import numpy as np
    rng = np.random.default_rng(11)
    raw = os.path.join(root, "ZINC", "raw")
    os.makedirs(raw, exist_ok=True)
    for split, n in (("train", N_TRAIN), ("val", N_VAL), ("test", N_TEST)):
        with open(os.path.join(raw, f"{split}.pickle"), "wb") as f:
            pickle.dump([mod.make_mol(rng) for _ in range(n)], f)
        with open(os.path.join(raw, f"{split}.index"), "w") as f:
            f.write(",".join(str(i) for i in range(n)) + ",")


def run_tool(name, *argv):
    """Runs tools/<name>.py's main() in this process with ``argv`` as its
    command line."""
    path = os.path.join(ROOT, "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    saved = sys.argv
    sys.argv = [path, *map(str, argv)]
    try:
        mod.main()
    finally:
        sys.argv = saved


def write_gin_fixture(root, name="MUTAG", n_graphs=188, seed=5):
    """A GIN-format TU dataset at MUTAG's scale under <root>/<name>: 188
    graphs (class 1 a third of them) of 10..28 nodes, a random tree plus
    one extra edge (four for class 1), 7 node tags; and 10-fold index
    files stratified by class (folds split by index modulo 10 can hold
    one class only)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    d = os.path.join(root, name)
    os.makedirs(os.path.join(d, "10fold_idx"))
    labels = (np.arange(n_graphs) % 3 == 0).astype(np.int64)
    rng.shuffle(labels)
    lines = [str(n_graphs)]
    for label in labels:
        n = int(rng.integers(10, 29))
        adj = [set() for _ in range(n)]
        edges = [(u, int(rng.integers(0, u))) for u in range(1, n)]
        edges += [tuple(map(int, rng.integers(0, n, 2)))
                  for _ in range(1 + 3 * label)]
        for u, v in edges:
            if u != v:
                adj[u].add(v)
                adj[v].add(u)
        tags = rng.integers(0, 7, n)
        lines.append(f"{n} {label}")
        lines += [f"{tags[u]} {len(adj[u])} "
                  + " ".join(map(str, sorted(adj[u]))) for u in range(n)]
    with open(os.path.join(d, f"{name}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
    fold_of = np.zeros(n_graphs, np.int64)
    for c in (0, 1):
        idx = np.flatnonzero(labels == c)
        fold_of[idx] = np.arange(len(idx)) % 10
    for f in range(10):
        for split, idx in (("train", np.flatnonzero(fold_of != f)),
                           ("test", np.flatnonzero(fold_of == f))):
            with open(os.path.join(d, "10fold_idx",
                                   f"{split}_idx-{f + 1}.txt"), "w") as fh:
                fh.write("\n".join(map(str, idx)) + "\n")


def qm9_argv(dataset_dir, save_dir, device, backend, extra=()):
    """train_qm9 at the canonical width; ``extra`` picks the sweep's
    config (its first: --virtual_node --use_rd)."""
    return ["--dataset_dir", dataset_dir, "--save_dir", save_dir,
            "--device", device, "--backend", backend, "--K", str(QM9_K),
            "--num_layer", str(QM9_L), "--hidden_size", str(QM9_H),
            "--batch_size", str(QM9_BATCH), "--num_epochs", str(QM9_EPOCHS),
            "--task", "0", "--seed", str(SEED), *extra]


def generated_argv(label, work, device, backend):
    """The GENERATED script ``label`` for GEN_EPOCHS epochs, one run."""
    return ["--save_dir", os.path.join(work, label), "--device", device,
            "--backend", backend, "--dataset_dir", work, "--num_epochs",
            str(GEN_EPOCHS), "--runs", "1", "--seed", str(SEED),
            *GENERATED[label][1]]


QM9_VN_RD = ("--virtual_node", "--use_rd")
QM9_PRIME = ("--model_name", "KPGINPrime", "--K", str(PRIME_K),
             "--num_layer", str(PRIME_L), "--residual", "--use_rd")


def train_argv(dataset_dir, save_dir, device):
    return ["--dataset_dir", dataset_dir, "--save_dir", save_dir,
            "--device", device, "--backend", "pallas", "--model_name",
            "KPGINPlus", "--K", str(K), "--num_layer", str(L),
            "--hidden_size", str(H), "--JK", "concat", "--residual",
            "--combine", "attention", "--batch_size", str(BATCH),
            "--num_epochs", "1", "--runs", "1", "--seed", str(SEED)]


def csl_argv(save_dir, device, backend, model_name="KPGIN", extra=()):
    return ["--save_dir", save_dir, "--device", device, "--backend", backend,
            "--model_name", model_name, "--K", str(CSL_K), "--num_layer",
            str(CSL_L), "--hidden_size", str(CSL_H), "--batch_size",
            str(CSL_BATCH), "--num_epochs", str(CSL_EPOCHS), "--folds", "1",
            "--seed", str(SEED), *extra]


def first_batch(loader):
    """The first batch a (shuffled) loader yields, leaving its shuffle
    where it was: every call gives the batch the loader's next epoch
    starts with."""
    state = loader.rng.bit_generator.state
    it = iter(loader)
    batch = next(it)
    it.close()
    loader.rng.bit_generator.state = state
    return batch


def kernel_bound_ms(csr, D, x_bytes, fused=False):
    """Least time for one launch on this CSR's data: the rows of x that
    some edge gathers read once, indptr and senders read once (and, fused,
    the codes and the table rows some edge reads), the f32 output written
    once, over the HBM rate; the adds (one per gathered element, two
    fused) over the f32 rate.  Returns (ms, by)."""
    import torch
    n_rows, n_edges = csr.n_rows, csr.senders.shape[0]
    s = csr.senders
    n_read = int(torch.unique(s[(s >= 0) & (s < csr.n_cols)]).numel())
    nbytes = n_read * D * x_bytes + (n_rows + 1) * 4 + n_edges * 4 \
        + n_rows * D * 4
    adds = n_edges * D
    if fused:
        rows = torch.repeat_interleave(
            torch.arange(n_rows, device=s.device),
            (csr.indptr[1:] - csr.indptr[:-1]).long(), output_size=n_edges)
        c = csr.codes.long()
        hop_k = (rows >= csr.rows_per_hop).long()
        n_tab = int(torch.unique((c * 2 + hop_k)[c > 0]).numel())
        nbytes += n_edges * 4 + n_tab * D * 4
        adds *= 2
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = adds / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def misalign(t):
    """A contiguous copy of t whose data_ptr is one element past a 16-byte
    boundary (the kernel's scalar variant)."""
    import torch
    buf = torch.empty(t.numel() + 16, dtype=t.dtype, device=t.device)
    view = buf[1:1 + t.numel()].view(t.shape)
    view.copy_(t)
    return view


def launched(spmm, fn):
    """fn()'s result and the kernel variants it launched, with counts."""
    before = Counter(spmm.gather_segment_sum.variant_launches)
    out = fn()
    after = Counter(spmm.gather_segment_sum.variant_launches)
    after.subtract(before)
    return out, {k: v for k, v in after.items() if v}


@contextlib.contextmanager
def relu_branches(torch, inputs, replay):
    """Within the block, every ``F.relu`` call of the model records its
    input on the host into ``inputs`` (``replay`` False), or (``replay``
    True) takes the branch that the input of the same call in ``inputs``
    took: relu(x) becomes where(inputs[i] > 0, x, 0), gradient included.
    ReLU is the one branch point of the gated models.  Yields, per call
    replayed, (inputs whose own sign differs from the recorded one,
    largest |x| or recorded |x| among them, largest |x| of the call)."""
    F = torch.nn.functional
    relu = F.relu
    flips = []

    def recording(x, inplace=False):
        inputs.append(x.detach().float().cpu())
        return relu(x, inplace)

    def replaying(x, inplace=False):
        i = len(flips)
        check(i < len(inputs) and inputs[i].shape == x.shape,
              f"ReLU call {i} {tuple(x.shape)} is not the recorded step's")
        keep = (inputs[i] > 0).to(x.device)
        xd = x.detach().float()
        other = keep != (xd > 0)
        mag = torch.maximum(xd.abs(), inputs[i].to(x.device).abs())[other]
        flips.append((int(other.sum()),
                      float(mag.max()) if mag.numel() else 0.0,
                      float(xd.abs().max())))
        return torch.where(keep, x, torch.zeros_like(x))
    F.relu = replaying if replay else recording
    try:
        yield flips
    finally:
        F.relu = relu
    check(not replay or len(flips) == len(inputs),
          f"{len(flips)} ReLU calls replayed, {len(inputs)} recorded")


def time_ms(torch, fn, inputs, iters=200, warmup=20):
    """Device time per call with CUDA events.  A sleep kernel queued
    ahead keeps the device busy while the host enqueues every timed call,
    so host launch overhead does not open gaps between them."""
    t0 = time.perf_counter()
    for i in range(warmup):
        fn(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    host_per_call = (time.perf_counter() - t0) / warmup
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2 GHz: cycles for 1.5x the host's enqueue time of the timed loop
    torch.cuda._sleep(int(min(1.5 * iters * host_per_call, 2.0) * 2e9))
    start.record()
    for i in range(iters):
        fn(inputs[i % len(inputs)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_step_ms(torch, step, warmup=3, steps=10):
    """Host ms per step over ``steps`` steps that end in a synchronize,
    after ``warmup`` steps."""
    for _ in range(warmup):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def profile_step(torch, step, step_ms, label, steps=3):
    """Device time per train step by kernel (torch.profiler), the
    device's idle share against the unprofiled step time, and the time of
    ``indexing_backward_kernel`` (the serialising backward of a gather
    into a small table, PERF.md)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / steps
    launches = sum(e.count for e in kernels) / steps
    if busy_ms == 0.0:
        log(f"[profile] {label} train step: device time not measured (the "
            "profiler recorded no kernel)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    ib = [e for e in kernels if "indexing_backward" in e.key]
    log(f"[profile] {label} train step: indexing_backward_kernel "
        + (", ".join(f"{e.self_device_time_total / 1e3 / steps:.3f} ms/step "
                     f"(x{e.count // steps})" for e in ib) if ib else "none"))
    log(f"[profile] {label} train step: device busy {busy_ms:.3f} ms of "
        f"{step_ms:.2f} ms (idle share {1 - busy_ms / step_ms:.3f}), "
        f"{launches:.0f} kernel launches; top kernels by device ms/step: "
        + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3 / steps:.3f}"
                    f" (x{e.count // steps})" for e in top))


def main():
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: this smoke "
                           "run needs an NVIDIA GPU")
    check(os.path.isdir(os.path.join(ROOT, "kpgnn_tpu_torch")),
          f"no kpgnn_tpu_torch package beside {__file__}: run this script "
          f"from a checkout of the repo")
    sys.path.insert(0, ROOT)
    import kpgnn_tpu_torch
    check(os.path.dirname(os.path.abspath(kpgnn_tpu_torch.__file__))
          == os.path.join(ROOT, "kpgnn_tpu_torch"),
          "kpgnn_tpu_torch was not imported from this checkout")
    import numpy as np
    from kpgnn_tpu_torch.data.expressiveness import generate_csl
    from kpgnn_tpu_torch.data.molecules import load_zinc
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.ops import cuda_lib, spmm
    from kpgnn_tpu_torch.scripts import common, train_csl, train_qm9, train_zinc
    from kpgnn_tpu_torch.train.loader import GraphLoader
    from kpgnn_tpu_torch.train.loop import (_batch_target_mask, _masked_loss,
                                            train_step)
    from kpgnn_tpu_torch.train.state import make_optimizer

    common.set_full_f32()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    marks = [("start", time.perf_counter())]

    def mark(name):
        """Ends the phase ``name``: its seconds go on the [phases] line."""
        marks.append((name, time.perf_counter()))

    # ---- 1. build ----
    secs = cuda_lib.build_all([spmm.KERNEL_SOURCE])
    hashes = {s: cuda_lib.source_hash(s) for s in secs}
    log(f"[build] {kind} ({card}); source hash {json.dumps(hashes)}; nvcc "
        f"seconds: {json.dumps(secs)}")
    # the rtol 1e-4 gates against the CPU hold only in full f32
    check(not (torch.backends.cuda.matmul.allow_tf32
               or torch.backends.cudnn.allow_tf32),
          "TF32 is on for cuBLAS or cuDNN after common.set_full_f32()")

    work = tempfile.mkdtemp(prefix="kpgnn_smoke_")
    try:
        write_fixture(work)
        args = train_zinc.parser().parse_args(
            train_argv(work, os.path.join(work, "save"), "cuda"))
        splits = load_zinc(os.path.join(work, "ZINC"))
        mcfg = common.model_config(args, input_encoder=("embedding", 21),
                                   task="graph_regression", output_size=1)
        lk = common.loader_kwargs(args, mcfg)
        # the trainer's own loader (same seed), so the flagship plan has the
        # main path's shapes: the loader's worst-case n_pad over the split
        tl = GraphLoader(common.prepare(splits["train"], args), BATCH,
                         shuffle=True, seed=SEED, **lk)
        fb = tl.example()
        plan = fb.adj.to(dev)
        union_edges = sum(g.num_edges for g in tl.graphs[:BATCH])
        deg = plan.fwd.indptr[1:] - plan.fwd.indptr[:-1]
        codes = torch.unique(plan.fwd.codes).tolist()
        log(f"[plan] flagship batch: {int(fb.node_mask.sum())} nodes, "
            f"n_pad {fb.n_pad}, {union_edges} union edges, K*n_pad = "
            f"{plan.fwd.n_rows} rows, {int((deg > 0).sum())} of them with "
            f"an edge, at most {int(deg.max())} edges a row, "
            f"{plan.fwd.senders.shape[0]} live hop edges with {len(codes)} "
            f"attr codes {codes}; rows up to the last live one per hop "
            f"{plan.fwd.hop_live}")

        # the CSL slice's data: the trainer's fold-0 train loader (same
        # seed), so the CSL plan has the main path's shapes
        cargs = train_csl.parser().parse_args(
            csl_argv(os.path.join(work, "csl"), "cuda", "pallas"))
        raw = generate_csl()
        for g in raw:
            g["x"] = np.ones((g["num_nodes"], 1), dtype=np.float32)
        cgraphs = common.prepare(raw, cargs)
        tr, va, te = train_csl.splits([int(g.y[0]) for g in cgraphs], 1,
                                      SEED)[0]
        ctrain = [cgraphs[i] for i in tr]
        cmcfg = common.model_config(cargs, input_encoder=("linear", 1),
                                    task="graph_classification",
                                    output_size=10)
        clk = common.loader_kwargs(cargs, cmcfg)
        ctl = GraphLoader(ctrain, CSL_BATCH, shuffle=True, seed=SEED, **clk)
        cfb = ctl.example()
        cplan = cfb.adj.to(dev)
        cdeg = cplan.fwd.indptr[1:] - cplan.fwd.indptr[:-1]
        ck = cplan.countsk_hm
        log(f"[plan] csl batch: {int(cfb.node_mask.sum())} nodes, n_pad "
            f"{cfb.n_pad}, {sum(g.num_edges for g in ctrain[:CSL_BATCH])} "
            f"union edges, K*n_pad = {cplan.fwd.n_rows} rows, "
            f"{int((cdeg > 0).sum())} of them with an edge, at most "
            f"{int(cdeg.max())} edges a row, {cplan.fwd.senders.shape[0]} "
            f"live hop edges with {len(torch.unique(cplan.fwd.codes))} attr "
            f"codes; rows up to the last live one per hop "
            f"{cplan.fwd.hop_live}; countsk_hm {tuple(ck.shape)} "
            f"({ck.numel() * 4 / 1e6:.1f} MB); split {len(tr)} / {len(va)} "
            f"/ {len(te)} graphs")
        coo_tl = GraphLoader(ctrain, CSL_BATCH, shuffle=True, seed=SEED,
                             mode="coo")

        # the QM9 slice's data: the trainer's train split in each backend's
        # loader (same seed), so the QM9 plan has the main path's shapes;
        # and the sweep's KPGINPrime K=16 config on the same split
        run_tool("make_qm9_fixture", "--out", work, "--n", QM9_MOLECULES,
                 "--seed", QM9_FIXTURE_SEED)

        def qm9_data(extra, backend):
            a = train_qm9.parser().parse_args(qm9_argv(
                work, os.path.join(work, "qm9"), "cuda", backend, extra))
            (train, _, _), _ = train_qm9.task_splits(
                common.prepare(train_qm9.load(a), a), a)
            cfg = common.model_config(a, input_encoder=("qm9", 0),
                                      task="graph_regression", output_size=1)
            return a, train, cfg
        qargs, qtrain, qmcfg = qm9_data(QM9_VN_RD, "pallas")
        qlk = common.loader_kwargs(qargs, qmcfg)
        qloaders = {mode: GraphLoader(qtrain, QM9_BATCH, shuffle=True,
                                      seed=SEED, **dict(qlk, mode=mode))
                    for mode in ("pallas", "coo", "dense")}
        qfb = qloaders["pallas"].example()
        qplan = qfb.adj.to(dev)
        qvk = qplan.countsk_hm.shape[2]
        pargs, ptrain, pmcfg = qm9_data(QM9_PRIME, "pallas")
        ptl = GraphLoader(ptrain, QM9_BATCH,
                          **common.loader_kwargs(pargs, pmcfg))
        pfb = ptl.example()
        pplan = pfb.adj.to(dev)
        pvk = pplan.countsk_hm.shape[2]
        for label, b, p in (("qm9", qfb, qplan),
                            (f"qm9 KPGINPrime k={PRIME_K}", pfb, pplan)):
            d = p.fwd.indptr[1:] - p.fwd.indptr[:-1]
            log(f"[plan] {label} batch: {int(b.node_mask.sum())} nodes, "
                f"n_pad {b.n_pad}, K*n_pad = {p.fwd.n_rows} rows, "
                f"{int((d > 0).sum())} of them with an edge, at most "
                f"{int(d.max())} edges a row, {p.fwd.senders.shape[0]} live "
                f"hop edges; rows up to the last live one per hop "
                f"{p.fwd.hop_live}")
        qdb = qloaders["dense"].example()
        log(f"[plan] qm9 dense batch: n_slot {qloaders['dense'].n_slot}, "
            f"hop_attr {tuple(qdb.adj.hop_attr.shape)}; split "
            f"{len(qtrain)} train graphs")

        # the generated-data slices: each script's own data and model
        # config, and its run-0 (TU: fold-0) train split in each backend's
        # loader (same seed), so each plan has its main path's shapes
        write_gin_fixture(work)
        slices = {}
        for label, (name, _, loss, node_level) in GENERATED.items():
            mod = importlib.import_module(f"kpgnn_tpu_torch.scripts.{name}")
            argv = generated_argv(label, work, "cuda", "pallas")
            ga = mod.parser().parse_args(argv)
            if name == "train_tu":
                graphs, folds, n_tag, n_cls = mod.load(ga)
                gcfg = mod.config(ga, n_tag, n_cls)
                g_tr, g_te = folds[0]
                g_split = ([graphs[i] for i in g_tr], [], g_te)
            else:
                gsplits = mod.datasets(ga)
                gcfg = mod.config(ga)
                g_split = tuple(gsplits[k] for k in ("train", "val", "test"))
            gB = ga.batch_size
            g_lk = common.loader_kwargs(ga, gcfg)
            g_loaders = {m: GraphLoader(g_split[0], gB, shuffle=True,
                                        seed=SEED, y_is_node_level=node_level,
                                        **dict(g_lk, mode=m))
                         for m in ("pallas", "coo", "dense")}
            gb = g_loaders["pallas"].example()
            sl = slices[label] = SimpleNamespace(
                main=mod.main, argv=argv, cfg=gcfg, loss=loss,
                node_level=node_level, L=ga.num_layer,
                D=ga.hidden_size // (1 if ga.model_name == "KPGINPlus"
                                     else ga.K),
                epochs=GEN_EPOCHS, train_steps=len(g_loaders["pallas"]),
                val_steps=math.ceil(len(g_split[1]) / gB),
                test_steps=math.ceil(len(g_split[2]) / gB),
                loaders=g_loaders, batch=gb, plan=gb.adj.to(dev), args=ga,
                union=sum(g.num_edges for g in g_split[0][:gB]))
            gd = sl.plan.fwd.indptr[1:] - sl.plan.fwd.indptr[:-1]
            log(f"[plan] {label} batch ({ga.model_name} K={ga.K} L="
                f"{ga.num_layer} H={ga.hidden_size}, batch {gB}, kernel D="
                f"{sl.D}): {int(gb.node_mask.sum())} nodes, n_pad "
                f"{gb.n_pad}, {sl.union} union edges, K*n_pad = "
                f"{sl.plan.fwd.n_rows} rows, {int((gd > 0).sum())} of them "
                f"with an edge, at most {int(gd.max())} edges a row, "
                f"{sl.plan.fwd.senders.shape[0]} live hop edges; rows up to "
                f"the last live one per hop {sl.plan.fwd.hop_live}; split "
                + " / ".join(str(len(x)) for x in g_split) + " graphs")

        def collate_ms(loader):
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                loader.example()
                ts.append((time.perf_counter() - t0) * 1e3)
            return min(ts)
        log(f"[host] csl {CSL_BATCH}-graph batch collate (min of 5): "
            f"pallas plan {collate_ms(ctl):.1f} ms, coo "
            f"{collate_ms(coo_tl):.1f} ms")

        mark("build and data")
        # ---- 2. kernels against their plain versions ----
        gen = torch.Generator(device=dev).manual_seed(0)
        errs = Counter()            # variant -> max |err| over its checks
        errs_w = Counter()          # (variant, shape) -> the same there
        f32_tol = dict(rtol=0.0, atol=1e-5)

        def note(variants, err, shape):
            for v in variants:
                errs[v] = max(errs[v], err)
                errs_w[v, shape] = max(errs_w[v, shape], err)

        def compare(name, fwd, bwd, D, dtype=torch.float32, hub=False,
                    mis=False, shape=None):
            x = torch.randn(fwd.n_cols, D, device=dev, generator=gen
                            ).to(dtype)
            w = torch.randn(fwd.n_rows, D, device=dev, generator=gen)
            if mis:
                w = misalign(w)
            # kernel: forward over fwd, autograd backward over bwd
            xk = (misalign(x) if mis else x.clone()).requires_grad_(True)
            out, v_f = launched(
                spmm, lambda: spmm._GatherSegment.apply(xk, fwd, bwd))
            _, v_b = launched(spmm, lambda: (out * w).sum().backward())
            out = out.detach()
            grad_k, v_g = launched(spmm, lambda: bwd.gather(w))
            check(xk.grad.dtype == dtype
                  and torch.equal(xk.grad, grad_k.to(dtype)),
                  f"{name}: autograd backward is not the kernel over bwd")
            vec = D * x.element_size() % 16 == 0 and not mis
            expect_f = spmm.variant_name(dtype, vec, False)
            expect_g = spmm.variant_name(torch.float32,
                                         D % 4 == 0 and not mis, False)
            check(v_f == {expect_f: 1} and v_g == {expect_g: 1},
                  f"{name}: launched {v_f} forward, {v_g} backward; "
                  f"expected {expect_f}, {expect_g}")
            # plain version: forward on the same values, f32 gradient
            ref = spmm.gather_segment_sum_reference(
                x, fwd.indptr, fwd.senders, fwd.n_rows)
            xr = x.float().clone().requires_grad_(True)
            (spmm.gather_segment_sum_reference(
                xr, fwd.indptr, fwd.senders, fwd.n_rows) * w).sum().backward()
            torch.cuda.synchronize()
            check(out.dtype == torch.float32 and out.shape == ref.shape,
                  f"{name}: output {out.dtype} {tuple(out.shape)}")
            tol_f = (dict(rtol=1e-3, atol=1e-5) if dtype == torch.bfloat16
                     else f32_tol)
            tol_b = f32_tol         # the gradient is f32 either way
            if hub:     # summation-order bound of 10k-term f32 sums
                absx = spmm.gather_segment_sum_reference(
                    x.abs(), fwd.indptr, fwd.senders, fwd.n_rows)
                tol_f = dict(rtol=0.0, atol=1e-5 + 1e-6 * float(absx.max()))
                absw = spmm.gather_segment_sum_reference(
                    w.abs(), bwd.indptr, bwd.senders, bwd.n_rows)
                tol_b = dict(rtol=0.0, atol=1e-5 + 1e-6 * float(absw.max()))
            ef = float((out - ref).abs().max())
            eb = float((grad_k - xr.grad).abs().max())
            torch.testing.assert_close(out, ref, **tol_f,
                                       msg=lambda m: f"{name} fwd: {m}")
            torch.testing.assert_close(grad_k, xr.grad, **tol_b,
                                       msg=lambda m: f"{name} bwd: {m}")
            if not hub:
                note(v_f, ef, D if shape is None else shape)
                note(set(v_b) | set(v_g), eb, D if shape is None else shape)
            log(f"[check] {name}: rows {fwd.n_rows} cols {fwd.n_cols} "
                f"edges {fwd.senders.shape[0]} D {D} {str(dtype)[6:]}: "
                f"max |err| fwd {ef:.3e} ({expect_f}) bwd {eb:.3e} "
                f"({expect_g})")

        for k in range(1, K + 1):
            sub = plan.slice_hops(k)
            compare(f"flagship k={k}", sub.fwd, sub.bwd, H)
        compare(f"flagship k={K} bf16", plan.fwd, plan.bwd, H,
                dtype=torch.bfloat16)
        compare(f"flagship k={K} misaligned", plan.fwd, plan.bwd, H,
                mis=True)
        compare(f"flagship k={K} bf16 misaligned", plan.fwd, plan.bwd, H,
                dtype=torch.bfloat16, mis=True)

        def csr_pair(recv, send, n_rows, n_cols):
            """fwd CSR over all edges, bwd over the non-null ones."""
            fwd, _ = spmm.build_csr(recv, send, n_rows, n_cols)
            ok = send < n_cols
            bwd, _ = spmm.build_csr(send[ok], recv[ok], n_cols, n_rows)
            return fwd.to(dev), bwd.to(dev)

        rng = np.random.default_rng(1)
        # empty rows (only even rows below 2048 receive) + null senders
        e = 5000
        recv = 2 * rng.integers(0, 1024, e)
        send = rng.integers(0, 4096 + 100, e)
        compare("empty rows + null senders", *csr_pair(recv, send, 4096,
                                                       4096), H)
        recv = np.concatenate([np.full(10000, 7), rng.integers(0, 2048,
                                                               2000)])
        send = rng.integers(0, 2048, 12000)
        compare("10k-edge hub", *csr_pair(recv, send, 2048, 2048), H,
                hub=True)
        compare("rectangular", *csr_pair(rng.integers(0, 1000, 8000),
                                         rng.integers(0, 3000, 8000),
                                         1000, 3000), 64)
        compare("D=13", *csr_pair(rng.integers(0, 2048, 10000),
                                  rng.integers(0, 2048, 10000), 2048,
                                  2048), 13)
        compare("D=13 bf16", *csr_pair(rng.integers(0, 2048, 10000),
                                       rng.integers(0, 2048, 10000), 2048,
                                       2048), 13, dtype=torch.bfloat16)

        V1, VK = plan.counts1.shape[1], plan.countsk_hm.shape[2]

        def compare_fused(name, sub, D, dtype=torch.float32, mis=False,
                          VK=VK, shape=None):
            """The fused forward (gather + edge-embedding term) and its
            autograd grads of x and both tables against the plain version's
            autograd; VK is the hop-k table's rows (the full plan's)."""
            k, f, n = sub.K, sub.fwd, sub.counts1.shape[0]
            V1 = sub.counts1.shape[1]
            x = torch.randn(f.n_cols, D, device=dev, generator=gen).to(dtype)
            t1 = torch.randn(V1, D, device=dev, generator=gen)
            tk = torch.randn(VK, D, device=dev, generator=gen)
            w = torch.randn(f.n_rows, D, device=dev, generator=gen)
            xk = (misalign(x) if mis else x.clone()).requires_grad_(True)
            t1k, tkk = (t.clone().requires_grad_(True) for t in (t1, tk))
            out, v_f = launched(
                spmm, lambda: spmm._FusedKHop.apply(xk, t1k, tkk, sub))
            _, v_b = launched(spmm, lambda: (out * w).sum().backward())
            out = out.detach()
            grad_k = sub.bwd.gather(w)
            check(torch.equal(xk.grad, grad_k.to(dtype)),
                  f"{name}: dx is not the gather kernel over bwd")
            expect_f = spmm.variant_name(
                dtype, D * x.element_size() % 16 == 0 and not mis, True)
            expect_b = spmm.variant_name(torch.float32, D % 4 == 0, False)
            check(v_f == {expect_f: 1} and v_b == {expect_b: 1},
                  f"{name}: launched {v_f} forward, {v_b} backward; "
                  f"expected {expect_f}, {expect_b}")
            xr = x.float().clone().requires_grad_(True)
            t1r, tkr = (t.clone().requires_grad_(True) for t in (t1, tk))
            ref = spmm.gather_segment_sum_reference(
                xr, f.indptr, f.senders, f.n_rows, f.codes, t1r,
                None if k == 1 else tkr, n)
            (ref * w).sum().backward()
            ref = ref.detach()
            # summation-order bounds (module docstring): a relative factor
            # of the sum of |terms|, + 1e-5
            absf = spmm.gather_segment_sum_reference(
                x.float().abs(), f.indptr, f.senders, f.n_rows, f.codes,
                t1.abs(), None if k == 1 else tk.abs(), n)

            def rows_bound(n_rows):
                return 2 * math.sqrt(n_rows) * 2.0 ** -24
            grads = [("fwd", out, ref, absf, 1e-6),
                     ("dx", grad_k, xr.grad, None, 0.0),
                     ("d table1", t1k.grad, t1r.grad,
                      sub.counts1.t() @ w[:n].abs(), rows_bound(n))]
            if k > 1:
                ck = sub.countsk_hm.reshape(-1, VK)
                grads.append(("d tablek", tkk.grad, tkr.grad,
                              ck.t() @ w[n:].abs(), rows_bound(ck.shape[0])))
                check(bool((tkk.grad[0] == 0).all()),
                      f"{name}: d tablek row 0 is not 0")
            else:
                check(tkk.grad is None, f"{name}: k=1 gave a tablek grad")
            check(bool((t1k.grad[0] == 0).all()),
                  f"{name}: d table1 row 0 is not 0")
            torch.cuda.synchronize()
            msg = []
            for what, got, want, absum, rel in grads:
                tol = 1e-5 + (0.0 if absum is None
                              else rel * float(absum.max()))
                err = float((got - want).abs().max())
                torch.testing.assert_close(
                    got, want, rtol=0.0, atol=tol,
                    msg=lambda m: f"{name} {what}: {m}")
                msg.append(f"{what} {err:.3e} (tol {tol:.1e})")
                note(v_f if what == "fwd" else
                     (v_b if what == "dx" else ()), err,
                     D if shape is None else shape)
            log(f"[check] fused {name}: D {D} {str(dtype)[6:]}: max |err| "
                + ", ".join(msg) + f"; {expect_f} + {expect_b}")

        for k in range(1, K + 1):
            compare_fused(f"flagship k={k}", plan.slice_hops(k), H)
        compare_fused(f"flagship k={K} bf16", plan, H, dtype=torch.bfloat16)
        compare_fused(f"flagship k={K} misaligned", plan, H, mis=True)
        compare_fused(f"flagship k={K} bf16 misaligned", plan, H,
                      dtype=torch.bfloat16, mis=True)
        compare_fused(f"flagship k={K} D=13", plan, 13)
        # the CSL shapes: KPGIN/KPGCN/SAGE at D = H/K = 12 over the k=4
        # plan, GINE at D = H = 48 over its hop-1 slice
        cvk = cplan.countsk_hm.shape[2]
        compare(f"csl k={CSL_K}", cplan.fwd, cplan.bwd, CSL_H // CSL_K)
        compare_fused(f"csl k={CSL_K}", cplan, CSL_H // CSL_K, VK=cvk)
        c1 = cplan.slice_hops(1)
        compare("csl k=1 (GINE)", c1.fwd, c1.bwd, CSL_H)
        compare_fused("csl k=1 (GINE)", c1, CSL_H, VK=cvk)
        # the QM9 shapes: KPGINPlus at D = H = 128 over the k=8 plan (its
        # hop prefixes as the flagship's); KPGINPrime K=16 at D = H/K = 8
        # over the k=16 plan (the kernel's 16 hops) and its GINE layers at
        # D = H over the hop-1 slice
        compare(f"qm9 k={QM9_K}", qplan.fwd, qplan.bwd, QM9_H, shape="qm9")
        compare_fused(f"qm9 k={QM9_K}", qplan, QM9_H, VK=qvk, shape="qm9")
        compare(f"qm9 KPGINPrime k={PRIME_K}", pplan.fwd, pplan.bwd,
                QM9_H // PRIME_K, shape="prime")
        compare_fused(f"qm9 KPGINPrime k={PRIME_K}", pplan, QM9_H // PRIME_K,
                      VK=pvk, shape="prime")
        p1 = pplan.slice_hops(1)
        compare("qm9 KPGINPrime k=1 (GINE)", p1.fwd, p1.bwd, QM9_H,
                shape="prime gine")
        compare_fused("qm9 KPGINPrime k=1 (GINE)", p1, QM9_H, VK=pvk,
                      shape="prime gine")

        # the generated-data shapes: KPGINPlus at D = H (counting K=3
        # D=96, node property K=6 D=128, graph property K=6 D=96), KPGIN
        # at D = H/K (TU K=2 D=16)
        for label, sl in slices.items():
            compare(f"{label} k={sl.cfg.K}", sl.plan.fwd, sl.plan.bwd, sl.D,
                    shape=label)
            compare_fused(f"{label} k={sl.cfg.K}", sl.plan, sl.D,
                          VK=sl.plan.countsk_hm.shape[2], shape=label)

        # determinism: three launches of every variant on one input, each
        # on the CSR where the main path launches it
        fwd, bwd = plan.fwd, plan.bwd
        t1 = torch.randn(V1, H, device=dev, generator=gen)
        tk = torch.randn(VK, H, device=dev, generator=gen)
        tabs = dict(codes=fwd.codes, table1=t1, tablek=tk)
        variants = {}               # variant -> (csr, timed inputs, tables)
        for fused in (False, True):
            csr = fwd if fused else bwd
            x32 = [torch.randn(csr.n_cols, H, device=dev, generator=gen)
                   for _ in range(8)]
            for dtype in (torch.float32, torch.bfloat16):
                for mis in (False, True):
                    inputs = [v.to(dtype) for v in x32]
                    if mis:
                        inputs = [misalign(v) for v in inputs]
                    variants[spmm.variant_name(dtype, not mis, fused)] = (
                        csr, inputs, tabs if fused else {})
        for vname, (csr, inputs, kw) in variants.items():
            outs, v = launched(spmm, lambda: [csr.gather(inputs[0], **kw)
                                              for _ in range(3)])
            check(v == {vname: 3}, f"determinism: {vname} launched {v}")
            check(all(torch.equal(outs[0], o) for o in outs[1:]),
                  f"{vname}: three launches on one input differ")
        log(f"[check] determinism: 3 launches bit-identical for each of "
            f"{len(variants)} variants")

        mark("check")
        fused_v = spmm.variant_name(torch.float32, True, True)
        gather_v = spmm.variant_name(torch.float32, True, False)

        def first_step_loss(sl, batch, device):
            """The trainer's first-step loss before its update: the model
            initialized from SEED on the CPU, moved to ``device``; this
            launches no kernel (the CPU takes the plain version, COO and
            dense have no kernel)."""
            model = init_parameters(make_model(sl.cfg), SEED).to(device)
            b = batch.to(device)
            with torch.no_grad():
                (lsum, cnt), v = launched(spmm, lambda: _masked_loss(
                    model(b, train=True), b.y,
                    _batch_target_mask(b, sl.node_level), sl.loss))
            check(not v, f"a first step on {device} launched {v}")
            return float(lsum / cnt)

        def script_phase(label, sl, backends=("coo", "dense")):
            """``sl.main(sl.argv)`` on the card: its epochs, finite losses
            and metrics, per train step L fused forward + L gather backward
            launches at width sl.D and per eval step L fused (none at
            L = 0, the dense backend), and its first-step loss equal to the
            same step on the CPU (plain version) and on the card on each
            of ``backends`` (rtol 1e-4).  Returns (rows, step losses,
            launches per variant, per (variant, D))."""
            rows = []
            spmm.reset_launch_counts()
            t0 = time.perf_counter()
            result = sl.main(sl.argv, epoch_callback=lambda e, m, row:
                             rows.append(row))
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            v = dict(spmm.gather_segment_sum.variant_launches)
            w = +Counter(spmm.gather_segment_sum.width_launches)
            losses = np.concatenate([r["step_losses"] for r in rows])
            n_tr = sl.epochs * sl.train_steps
            n_ev = sl.epochs * sl.val_steps + sl.test_steps * sum(
                any(k.startswith("test_") for k in r) for r in rows)
            expect = ({fused_v: (n_tr + n_ev) * sl.L, gather_v: n_tr * sl.L}
                      if sl.L else {})
            log(f"[{label}] {len(rows)} epochs in {secs:.1f} s: {n_tr} train "
                f"steps, {n_ev} eval steps, train_loss "
                + ", ".join(f"{r['train_loss']:.5f}" for r in rows) + "; "
                + ", ".join(f"{k} {x:.5f}" for k, x in rows[-1].items()
                            if k.startswith(("val_", "test_"))
                            and isinstance(x, float))
                + f"; returns {result:.5f}; kernel launches {v} (expected "
                f"{expect}), by width {dict(w)}")
            check(len(rows) == sl.epochs and len(losses) == n_tr,
                  f"{label}: {len(rows)} epochs, {len(losses)} train steps")
            check(math.isfinite(result) and np.isfinite(losses).all()
                  and all(math.isfinite(x) for r in rows for x in r.values()
                          if isinstance(x, float)),
                  f"{label}: non-finite loss or metric")
            check(v == expect and set(w) <= {(fused_v, sl.D),
                                             (gather_v, sl.D)},
                  f"{label}: kernel launches {v} {dict(w)} != {expect} at "
                  f"D={sl.D} (per train step L fused forward + L gather "
                  f"backward, per eval step L fused forward)")
            refs = {"CPU": first_step_loss(sl, first_batch(
                sl.loaders["pallas"]), "cpu")}
            for name in backends:
                refs[f"--backend {name} on the card"] = first_step_loss(
                    sl, first_batch(sl.loaders[name]), dev)
            got = float(losses[0])
            rel = {k: abs(got - x) / abs(x) for k, x in refs.items()}
            log(f"[{label}] first-step loss GPU {got:.7f}, " + ", ".join(
                f"{k} {x:.7f} (rel diff {rel[k]:.2e})"
                for k, x in refs.items()))
            check(max(rel.values()) <= 1e-4,
                  f"{label}: first-step loss differs by "
                  + ", ".join(f"{x:.2e} ({k})" for k, x in rel.items())
                  + " > 1e-4")
            return rows, losses, v, w

        # ---- 3. the main path: train_zinc at full width ----
        zinc = SimpleNamespace(
            main=train_zinc.main,
            argv=train_argv(work, os.path.join(work, "save"), "cuda"),
            cfg=mcfg, loss="l1", node_level=False, L=L, D=H, epochs=1,
            train_steps=math.ceil(N_TRAIN / BATCH),
            val_steps=math.ceil(N_VAL / BATCH),
            test_steps=math.ceil(N_TEST / BATCH),
            loaders={"pallas": tl, "coo": GraphLoader(
                tl.graphs, BATCH, shuffle=True, seed=SEED, mode="coo")})
        path_w = script_phase("train", zinc, ("coo",))[3]

        mark("train")
        # ---- 4. the CSL slice: train_csl at the reference width ----
        csl = SimpleNamespace(
            main=train_csl.main,
            argv=csl_argv(os.path.join(work, "csl"), "cuda", "pallas"),
            cfg=cmcfg, loss="cross_entropy", node_level=False, L=CSL_L,
            D=CSL_H // CSL_K, epochs=CSL_EPOCHS,
            train_steps=math.ceil(len(tr) / CSL_BATCH),
            val_steps=math.ceil(len(va) / CSL_BATCH),
            test_steps=math.ceil(len(te) / CSL_BATCH),
            loaders={"pallas": ctl, "coo": coo_tl})
        csl_w = script_phase("csl", csl, ("coo",))[3]

        mark("csl")
        # ---- 5. the other families, one step at CSL width ----
        cb = cfb.to(dev)

        def step_grads(model, batch, lr, wd, loss, node_level=False):
            """(loss, {parameter: grad on the host}, launches) of one
            optimizer step."""
            (lsum, cnt), v = launched(spmm, lambda: train_step(
                model, make_optimizer(model.parameters(), lr, wd), batch,
                loss, node_level=node_level))
            return (float(lsum / cnt),
                    {n: None if p.grad is None else p.grad.cpu()
                     for n, p in model.named_parameters()}, v)

        def ulp_moved(model):
            """model with every weight moved by an ulp, w * (1 +- 2**-23)."""
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                    p.mul_(1.0 + sign.to(p.dtype) * 2.0 ** -23)
            return model

        def gradient_gate(label, name, cfg, loader, hp, loss, expect,
                          node_level=False):
            """One step of ``cfg``'s model, initialized from SEED, on the
            card against the same step on the CPU, on ``loader.example()``:
            the loss, every parameter gradient against the CPU step that
            takes the card's ReLU branches (the module docstring's gate),
            each ReLU input whose branch differs within 1e-4 of its call's
            largest |input| of 0, and the card's launches per variant
            against ``expect``.  Returns the launches per (variant, D)."""
            batch = loader.example()

            def fresh():
                return init_parameters(make_model(cfg), SEED)
            card_relu = []
            w0 = Counter(spmm.gather_segment_sum.width_launches)
            with relu_branches(torch, card_relu, replay=False):
                loss_g, grads_g, v_g = step_grads(
                    fresh().to(dev), batch.to(dev), *hp, loss, node_level)
            torch.cuda.synchronize()
            w = Counter(spmm.gather_segment_sum.width_launches)
            w.subtract(w0)
            loss_c, grads_own, v_c = step_grads(fresh(), batch, *hp, loss,
                                                node_level)
            with relu_branches(torch, card_relu, replay=True) as flips:
                _, grads, v_r = step_grads(fresh(), batch, *hp, loss,
                                           node_level)
            with relu_branches(torch, card_relu, replay=True):
                _, grads_u, _ = step_grads(ulp_moved(fresh()), batch, *hp,
                                           loss, node_level)
            rel = abs(loss_g - loss_c) / abs(loss_c)
            gscale = max(float(g.abs().max()) for g in grads.values()
                         if g is not None)

            def leaves(ref):
                """(err / leaf scale, err / tol, name, |err|, leaf scale,
                ulp move) of each gradient against ``ref``'s."""
                out = []
                for n, want in ref.items():
                    check((grads_g[n] is None) == (want is None),
                          f"{name}: {n} has a gradient on one device only")
                    if want is None:
                        continue
                    scale = float(grads[n].abs().max())
                    ulp = float((grads_u[n] - grads[n]).abs().max())
                    atol = 1e-4 * scale + 8 * ulp + 1e-7 * gscale
                    err = (grads_g[n] - want).abs()
                    out.append((float(err.max()) / max(scale, 1e-30),
                                float((err / (atol + 1e-4 * want.abs()))
                                      .max()),
                                n, float(err.max()), scale, ulp))
                return out

            def leaf(t):
                return (f"{t[2]} (|err| {t[3]:.2e}, leaf max {t[4]:.2e}, "
                        f"ulp-moved {t[5]:.2e}, err/tol {t[1]:.2f})")
            gated, own = leaves(grads), leaves(grads_own)
            over = [t for t in gated if t[1] > 1.0]
            n_flip = sum(f[0] for f in flips)
            flip_rel = max((f[1] / max(f[2], 1e-30) for f in flips),
                           default=0.0)
            log(f"[{label}] {name}: loss GPU {loss_g:.7f} CPU {loss_c:.7f} "
                f"(rel diff {rel:.2e}); ReLU: {n_flip} of "
                f"{sum(t.numel() for t in card_relu)} inputs in "
                f"{sum(f[0] > 0 for f in flips)} of {len(flips)} calls took "
                f"the other branch on the card, the largest |input| among "
                f"them {max((f[1] for f in flips), default=0.0):.2e}, "
                f"{flip_rel:.2e} of its "
                f"call's largest; {len(gated)} gradients against the CPU "
                f"step on the card's branches, largest {gscale:.2e}; worst "
                f"by |err| / leaf max: {leaf(max(gated))}; worst by |err| / "
                f"tol: {leaf(max(gated, key=lambda t: t[1]))}; against the "
                f"CPU step on its own branches, "
                f"{sum(t[1] > 1.0 for t in own)} outside the gate, worst "
                f"{leaf(max(own, key=lambda t: t[1]))}; kernel launches "
                f"{v_g} (expected {expect}), by width {dict(+w)}")
            if over:
                log(f"[{label}] {name}: {len(over)} gradients outside the "
                    "gate: " + "; ".join(leaf(t) for t in over))
            check(not over, f"{name}: {len(over)} gradients outside the gate")
            check(flip_rel <= 1e-4, f"{name}: a ReLU input {flip_rel:.2e} "
                  f"of its call's largest from 0 took another branch on the "
                  f"card")
            check(not v_c and not v_r,
                  f"{name}: a CPU step launched {v_c or v_r}")
            check(rel <= 1e-4, f"{name}: loss differs by {rel:.2e} > 1e-4")
            check(v_g == expect, f"{name}: launches {v_g} != {expect}")
            return +w

        fam_w = Counter()
        for name, extra, expect in (
                ("KPGCN", (), {gather_v: 2 * CSL_L}),
                ("KPGraphSAGE", ("--aggr", "mean"),
                 {fused_v: CSL_L, gather_v: CSL_L}),
                ("KPGINPrime", ("--num_l1_layer", "1"),
                 {fused_v: CSL_L, gather_v: CSL_L})):
            fargs = train_csl.parser().parse_args(csl_argv(
                os.path.join(work, "csl"), "cuda", "pallas", name, extra))
            fcfg = common.model_config(fargs, input_encoder=("linear", 1),
                                       task="graph_classification",
                                       output_size=10)
            fam_w.update(gradient_gate(
                "families", name, fcfg, ctl, (fargs.lr, fargs.l2_wd),
                "cross_entropy", expect))

        mark("families")
        # ---- 6. the QM9 slice: train_qm9 at the canonical width ----
        n_qeval = math.ceil(QM9_MOLECULES // 10 / QM9_BATCH)   # val or test
        qm9 = SimpleNamespace(
            main=train_qm9.main,
            argv=qm9_argv(work, os.path.join(work, "qm9"), "cuda", "pallas",
                          QM9_VN_RD),
            cfg=qmcfg, loss="mse", node_level=False, L=QM9_L, D=QM9_H,
            epochs=QM9_EPOCHS,
            train_steps=math.ceil(len(qtrain) / QM9_BATCH),
            val_steps=n_qeval, test_steps=n_qeval, loaders=qloaders)
        _, qlosses, _, qm9_w = script_phase("qm9", qm9)
        qm9_w.update(gradient_gate(
            "qm9", f"KPGINPlus K={QM9_K} L={QM9_L} vn+rd", qmcfg,
            qloaders["pallas"], (qargs.lr, qargs.l2_wd), "mse",
            {fused_v: QM9_L, gather_v: QM9_L}))

        mark("qm9")
        # ---- 7. the dense backend end to end, and KPGINPrime at K=16 ----
        qm9_dense = SimpleNamespace(**dict(vars(qm9), L=0, argv=qm9_argv(
            work, os.path.join(work, "qm9"), "cuda", "coo",
            QM9_VN_RD + ("--dense",))))
        _, dlosses, _, _ = script_phase("dense", qm9_dense, ())
        rel = abs(dlosses[0] - qlosses[0]) / abs(qlosses[0])
        log(f"[dense] first-step loss {dlosses[0]:.7f}, the pallas run's "
            f"{qlosses[0]:.7f} (rel diff {rel:.2e})")
        check(rel <= 1e-4, f"dense: first-step loss differs by {rel:.2e} "
              f"from the pallas run's > 1e-4")
        pd = QM9_H // PRIME_K
        prime_w = gradient_gate(
            "qm9", f"KPGINPrime K={PRIME_K} L={PRIME_L}", pmcfg, ptl,
            (pargs.lr, pargs.l2_wd), "mse",
            {fused_v: PRIME_L, gather_v: PRIME_L})
        expect_pw = {(fused_v, pd): 1, (gather_v, pd): 1,
                     (fused_v, QM9_H): PRIME_L - 1,
                     (gather_v, QM9_H): PRIME_L - 1}
        check(dict(prime_w) == expect_pw,
              f"KPGINPrime launches by width {dict(prime_w)} != {expect_pw} "
              f"(one K-hop layer at D={pd}, then GINE at D={QM9_H})")

        mark("dense and KPGINPrime")
        # ---- 8. the generated-data scripts at their canonical widths ----
        gen_w = {}
        for label, sl in slices.items():
            gen_w[label] = script_phase(label, sl)[3]
        sl = slices["nprop"]
        gen_w["nprop"].update(gradient_gate(
            "nprop", f"KPGINPlus K={sl.cfg.K} L={sl.L} node regression",
            sl.cfg, sl.loaders["pallas"], (sl.args.lr, sl.args.l2_wd),
            sl.loss, {fused_v: sl.L, gather_v: sl.L}, node_level=True))

        mark("generated")
        # ---- 9. times, on the flagship k=8 plan ----
        def sparse(c, dtype):
            n_e = c.senders.shape[0]
            return torch.sparse_csr_tensor(
                c.indptr.long(), c.senders.long(),
                torch.ones(n_e, device=dev, dtype=dtype),
                size=(c.n_rows, c.n_cols), check_invariants=False)

        def library_ms(c, inputs):
            """One torch.sparse.mm call on the same inputs; None where
            PyTorch has none for this type."""
            a = sparse(c, inputs[0].dtype)
            try:
                torch.sparse.mm(a, inputs[0])
            except RuntimeError as err:
                log(f"[time] torch.sparse.mm {inputs[0].dtype}: not "
                    f"timed ({str(err).splitlines()[0][:100]})")
                return None
            return time_ms(torch, lambda x: torch.sparse.mm(a, x), inputs)

        n = plan.counts1.shape[0]

        def timed(csr, inputs, kw):
            """(ms, plain ms, library ms, bound ms, bound by) of the kernel
            over csr."""
            ms = time_ms(torch, lambda x: csr.gather(x, **kw), inputs)
            kw_ref = dict(kw, rows_per_hop=csr.rows_per_hop) if kw else {}
            plain = time_ms(torch, lambda x: spmm.gather_segment_sum_reference(
                x, csr.indptr, csr.senders, csr.n_rows, **kw_ref), inputs)
            lib = None if kw else library_ms(csr, inputs)
            bound, by = kernel_bound_ms(csr, inputs[0].shape[1],
                                        inputs[0].element_size(), bool(kw))
            return ms, plain, lib, bound, by

        def show(t):
            ms, plain, lib, bound, by = t
            return (f"{ms:.4f} ms (plain {plain:.4f}, torch.sparse.mm "
                    f"{'none' if lib is None else format(lib, '.4f')}, bound "
                    f"{bound:.4f} by {by})")

        times = {}
        for vname, (csr, inputs, kw) in variants.items():
            times[vname], v = launched(spmm, lambda: timed(csr, inputs, kw))
            check(set(v) == {vname}, f"timing {vname} launched {v}")
            log(f"[time] {vname} over {'fwd' if kw else 'bwd'} "
                f"{show(times[vname])}")
        xs = variants[fused_v][1]       # f32 inputs with fwd.n_cols rows
        gather_f = timed(fwd, xs, {})
        n_e = fwd.senders.shape[0]
        log(f"[time] {gather_v} over fwd {show(gather_f)}; flagship "
            f"k={K} plan {fwd.n_rows} rows x D {H}, {n_e} edges; "
            f"{n_e / gather_f[0] / 1e3:.1f}M hop-edges/s")

        # the unfused composition the fused forward replaces: the gather,
        # then k counts @ table GEMMs on zero-row-0 tables, stack, add
        countsk_nm = plan.countsk.contiguous()         # (N, K-1, Vk)

        def unfused(x):
            out = fwd.gather(x).reshape(K, n, H)
            t1z = torch.cat([torch.zeros_like(t1[:1]), t1[1:]])
            tkz = torch.cat([torch.zeros_like(tk[:1]), tk[1:]])
            parts = [plan.counts1 @ t1z] + [countsk_nm[:, k - 1] @ tkz
                                            for k in range(1, K)]
            return out + torch.stack(parts, dim=0)
        got, want = unfused(xs[0]).reshape(-1, H), fwd.gather(xs[0], **tabs)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4,
                                   msg=lambda m: f"unfused vs fused: {m}")
        ms_unf = time_ms(torch, unfused, xs)
        log(f"[time] fused forward {times[fused_v][0]:.4f} ms vs the "
            f"unfused composition it replaces {ms_unf:.4f} ms (gather + {K} "
            f"GEMMs + stack + add; bound {times[fused_v][3]:.4f}); gather "
            f"alone {gather_f[0]:.4f} ms")

        # flagship train step on one fixed batch
        model = init_parameters(make_model(mcfg), SEED).to(dev)
        opt = make_optimizer(model.parameters(), 1e-3)
        batch = fb.to(dev)
        step_ms = host_step_ms(torch, lambda: train_step(model, opt, batch))
        log(f"[time] flagship train step {step_ms:.2f} ms, "
            f"{union_edges / step_ms / 1e3:.3f}M union edges/s "
            f"({union_edges} union edges, batch {BATCH})")
        profile_step(torch, lambda: train_step(model, opt, batch), step_ms,
                     "flagship")

        mark("time flagship")
        # ---- the same times at the CSL shapes ----
        def shape_times(sub, D, label, vk):
            """The f32 variants where the main path launches them over this
            plan (the fused form over fwd, the gather over bwd) and the
            gather over fwd beside torch.sparse.mm; ``vk`` is the hop-k
            table's rows.  Returns the fused form's inputs and times."""
            t1c = torch.randn(sub.counts1.shape[1], D, device=dev,
                              generator=gen)
            tkc = (torch.randn(vk, D, device=dev, generator=gen)
                   if sub.K > 1 else None)
            kw = dict(codes=sub.fwd.codes, table1=t1c, tablek=tkc)
            xf = [torch.randn(sub.fwd.n_cols, D, device=dev, generator=gen)
                  for _ in range(8)]
            xb = [torch.randn(sub.bwd.n_cols, D, device=dev, generator=gen)
                  for _ in range(8)]
            out = {}
            for what, csr, xs, k, vname in (
                    ("fwd", sub.fwd, xf, kw, fused_v),
                    ("bwd", sub.bwd, xb, {}, gather_v),
                    ("fwd", sub.fwd, xf, {}, gather_v)):
                t, v = launched(spmm, lambda: timed(csr, xs, k))
                check(set(v) == {vname}, f"timing {label} {vname} launched "
                      f"{v}")
                out[vname, what] = t
                log(f"[time] {label} D={D} {vname} over {what} {show(t)}; "
                    f"{csr.n_rows} rows, {csr.senders.shape[0]} edges")
            return xf, kw, out

        _, _, gt = shape_times(c1, CSL_H, "csl k=1 (GINE)", cvk)
        xf, kw, ct = shape_times(cplan, CSL_H // CSL_K, f"csl k={CSL_K}",
                                 cvk)
        # KPGCN's aggregation, the composition a scale/mean epilogue would
        # replace: sender pre-scale, the gather, the sender-weighted
        # histograms, K GEMMs, the receiver scale
        dis = torch.rsqrt(cplan.hop_deg + 1.0)
        cn = cplan.counts1.shape[0]

        def gcn(x):
            return spmm.khop_spmm(
                x.reshape(CSL_K, cn, -1), kw["table1"], kw["tablek"], cplan,
                scale=dis, sender_scale=dis, hop_major=True)
        with torch.no_grad():
            _, v = launched(spmm, lambda: gcn(xf[0]))
            check(v == {gather_v: 1}, f"the KPGCN aggregation launched {v}")
            ms_gcn = time_ms(torch, gcn, xf)
        log(f"[time] csl k={CSL_K} D={CSL_H // CSL_K}: KPGCN aggregation "
            f"(pre-scale + gather + weighted histograms + {CSL_K} GEMMs + "
            f"receiver scale) {ms_gcn:.4f} ms; the fused form alone "
            f"{ct[fused_v, 'fwd'][0]:.4f} ms (bound "
            f"{ct[fused_v, 'fwd'][3]:.4f}), the gather alone "
            f"{ct[gather_v, 'fwd'][0]:.4f} ms")

        # the CSL train step on one fixed batch
        cmodel = init_parameters(make_model(cmcfg), SEED).to(dev)
        copt = make_optimizer(cmodel.parameters(), cargs.lr, cargs.l2_wd)

        def csl_step():
            return train_step(cmodel, copt, cb, "cross_entropy")
        _, v = launched(spmm, csl_step)
        check(v == {fused_v: CSL_L, gather_v: CSL_L},
              f"the CSL train step launched {v}")
        cstep_ms = host_step_ms(torch, csl_step)
        c_union = sum(g.num_edges for g in ctrain[:CSL_BATCH])
        log(f"[time] csl train step {cstep_ms:.2f} ms, "
            f"{c_union / cstep_ms / 1e3:.3f}M union edges/s ({c_union} "
            f"union edges, batch {CSL_BATCH})")
        profile_step(torch, csl_step, cstep_ms, "csl")

        mark("time csl")
        # ---- the same times at the QM9 shapes ----
        _, _, qt = shape_times(qplan, QM9_H, f"qm9 k={QM9_K}", qvk)
        _, _, pt = shape_times(pplan, pd, f"qm9 KPGINPrime k={PRIME_K}", pvk)
        _, _, pgt = shape_times(pplan.slice_hops(1), QM9_H,
                                "qm9 KPGINPrime k=1 (GINE)", pvk)
        # the QM9 train step on one fixed batch, on the kernel and on dense
        q_union = sum(g.num_edges for g in qtrain[:QM9_BATCH])
        for label, b, expect in (
                ("qm9 pallas", qfb, {fused_v: QM9_L, gather_v: QM9_L}),
                ("qm9 dense", qdb, {})):
            qmodel = init_parameters(make_model(qmcfg), SEED).to(dev)
            qopt = make_optimizer(qmodel.parameters(), qargs.lr)
            qb = b.to(dev)

            def qm9_step():
                return train_step(qmodel, qopt, qb, "mse")
            _, v = launched(spmm, qm9_step)
            check(v == expect, f"the {label} train step launched {v}")
            qstep_ms = host_step_ms(torch, qm9_step)
            log(f"[time] {label} train step {qstep_ms:.2f} ms, "
                f"{q_union / qstep_ms / 1e3:.3f}M union edges/s ({q_union} "
                f"union edges, batch {QM9_BATCH})")
            profile_step(torch, qm9_step, qstep_ms, label)
        mark("time qm9")
        # ---- the same times at the generated-data shapes ----
        gen_t = {label: shape_times(sl.plan, sl.D, f"{label} k={sl.cfg.K}",
                                    sl.plan.countsk_hm.shape[2])[2]
                 for label, sl in slices.items()}
        # the node-property train step on one fixed batch
        sl = slices["nprop"]
        nmodel = init_parameters(make_model(sl.cfg), SEED).to(dev)
        nopt = make_optimizer(nmodel.parameters(), sl.args.lr,
                              sl.args.l2_wd)
        nb = sl.batch.to(dev)

        def nprop_step():
            return train_step(nmodel, nopt, nb, "mse", node_level=True)
        _, v = launched(spmm, nprop_step)
        check(v == {fused_v: sl.L, gather_v: sl.L},
              f"the node-property train step launched {v}")
        nstep_ms = host_step_ms(torch, nprop_step)
        log(f"[time] nprop train step {nstep_ms:.2f} ms, "
            f"{sl.union / nstep_ms / 1e3:.3f}M union edges/s ({sl.union} "
            f"union edges, {int(sl.batch.node_mask.sum())} nodes, batch "
            f"{sl.args.batch_size})")
        profile_step(torch, nprop_step, nstep_ms, "nprop")
        mark("time generated")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(set(errs) == set(variants),
          f"variants checked {sorted(errs)} != {sorted(variants)}")
    # launches by (variant, D) of the flagship, CSL and family runs, whose
    # widths are all distinct, and of the QM9 run and KPGINPrime step
    zinc_csl_w = path_w + csl_w + fam_w
    all_launches = Counter()
    for (vname, _), n in sum(gen_w.values(),
                             zinc_csl_w + qm9_w + prime_w).items():
        all_launches[vname] += n
    # the main path's shapes, each timed on the CSR where it launches:
    # (name suffix, label, D, error key, fused times, gather times,
    # launches by (variant, D) of the run that takes that shape)
    shapes = [("", f"flagship k={K} plan", H, H, times[fused_v],
               times[gather_v], zinc_csl_w),
              ("", f"csl k={CSL_K} plan", CSL_H // CSL_K, CSL_H // CSL_K,
               ct[fused_v, "fwd"], ct[gather_v, "bwd"], zinc_csl_w),
              ("", "csl k=1 slice (GINE)", CSL_H, CSL_H, gt[fused_v, "fwd"],
               gt[gather_v, "bwd"], zinc_csl_w),
              (" qm9", f"qm9 k={QM9_K} plan", QM9_H, "qm9",
               qt[fused_v, "fwd"], qt[gather_v, "bwd"], qm9_w),
              (" qm9 KPGINPrime", f"qm9 KPGINPrime k={PRIME_K} plan", pd,
               "prime", pt[fused_v, "fwd"], pt[gather_v, "bwd"], prime_w),
              (" qm9 KPGINPrime GINE", "qm9 KPGINPrime k=1 slice (GINE)",
               QM9_H, "prime gine", pgt[fused_v, "fwd"],
               pgt[gather_v, "bwd"], prime_w)]
    shapes += [(f" {label}", f"{label} k={sl.cfg.K} plan", sl.D, label,
                gen_t[label][fused_v, "fwd"], gen_t[label][gather_v, "bwd"],
                gen_w[label]) for label, sl in slices.items()]
    check(set(zinc_csl_w) <= {(v, s[2]) for s in shapes[:3]
                              for v in (fused_v, gather_v)},
          f"the paths launched {dict(zinc_csl_w)}, outside the timed widths")
    entries = [dict(name=vname, **KERNEL, launches=all_launches.get(vname, 0),
                    max_abs_err=errs[vname], ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib)
               for vname, (ms, plain, lib, bound, by) in times.items()]
    for suffix, label, D, key, t_fused, t_gather, w in shapes:
        for vname, (ms, plain, lib, bound, by) in ((fused_v, t_fused),
                                                   (gather_v, t_gather)):
            entries.append(dict(
                name=f"{vname} D={D}{suffix}", **KERNEL,
                shape=f"{label}, D={D}", launches=w[vname, D],
                max_abs_err=errs_w[vname, key], ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=lib))
    log("[phases] seconds: " + ", ".join(
        f"{name} {t - t0:.1f}" for (_, t0), (name, t) in zip(marks, marks[1:]))
        + f"; total {marks[-1][1] - marks[0][1]:.1f}")
    log(card)
    log(json.dumps({"kernels": entries}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
