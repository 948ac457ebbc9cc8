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
  6. time   — on the flagship k=8 plan (CUDA events, after warm-up,
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
     collate time per CSL batch, and the CSL train step with its profile.
The last lines are the card's name and power limit, a ``kernels`` JSON
line, and ``{"ok": true, "device": {...}}``.  The ``kernels`` line has one
entry per kernel variant, timed on the flagship plan, with the launches
of the flagship, CSL and families runs at every width; then one entry per
variant and main-path width (the flagship's D=104, CSL's D=12 over the
k=4 plan, GINE's D=48 over its hop-1 slice), each with its own launches,
error, times and bound.

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
family-step gradients GPU vs CPU per parameter: rtol 1e-4 and an atol
of 1e-4 of that parameter's largest gradient, plus 8 times its f32
rounding, measured as how far its CPU gradient moves when every weight
moves by an ulp (w * (1 +- 2**-23)), plus 1e-7 of the model's largest
gradient.  A gradient that is 0 in exact arithmetic (a bias ahead of a
batch norm) is all rounding, and a sum that cancels (a scalar gate)
carries more than 1e-4 of itself; the measured term admits both without
widening any other parameter's bound.
"""
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

ROOT = os.path.dirname(os.path.abspath(__file__))
K, L, H, BATCH = 8, 8, 104, 64
N_TRAIN, N_VAL, N_TEST = 1024, 128, 128
SEED = 234
CSL_K, CSL_L, CSL_H, CSL_BATCH, CSL_EPOCHS = 4, 4, 48, 64, 2
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
    """The first batch a (shuffled) loader yields."""
    it = iter(loader)
    batch = next(it)
    it.close()
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
    from kpgnn_tpu_torch.scripts import common, train_csl, train_zinc
    from kpgnn_tpu_torch.train.loader import GraphLoader
    from kpgnn_tpu_torch.train.loop import _masked_loss, train_step
    from kpgnn_tpu_torch.train.state import make_optimizer

    common.set_full_f32()
    dev = torch.device("cuda")
    card = card_line()
    kind = torch.cuda.get_device_name(0)

    # ---- 1. build ----
    secs = cuda_lib.build_all([spmm.KERNEL_SOURCE])
    hashes = {s: cuda_lib.source_hash(s) for s in secs}
    log(f"[build] {kind} ({card}); source hash {json.dumps(hashes)}; nvcc "
        f"seconds: {json.dumps(secs)}")

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

        # ---- 2. kernels against their plain versions ----
        gen = torch.Generator(device=dev).manual_seed(0)
        errs = Counter()            # variant -> max |err| over its checks
        errs_w = Counter()          # (variant, D) -> the same at width D
        f32_tol = dict(rtol=0.0, atol=1e-5)

        def note(variants, err, D):
            for v in variants:
                errs[v] = max(errs[v], err)
                errs_w[v, D] = max(errs_w[v, D], err)

        def compare(name, fwd, bwd, D, dtype=torch.float32, hub=False,
                    mis=False):
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
                note(v_f, ef, D)
                note(set(v_b) | set(v_g), eb, D)
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
                          VK=VK):
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
                     (v_b if what == "dx" else ()), err, D)
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

        # ---- 3. the main path: train_zinc at full width ----
        rows = []
        spmm.reset_launch_counts()
        t0 = time.perf_counter()
        mae = train_zinc.main(
            train_argv(work, os.path.join(work, "save"), "cuda"),
            epoch_callback=lambda e, m, row: rows.append(row))
        torch.cuda.synchronize()
        path_launches = dict(spmm.gather_segment_sum.variant_launches)
        path_w = Counter(spmm.gather_segment_sum.width_launches)
        launches = sum(path_launches.values())
        train_s = time.perf_counter() - t0
        n_train = math.ceil(N_TRAIN / BATCH)
        n_eval = math.ceil(N_VAL / BATCH) + math.ceil(N_TEST / BATCH)
        expect = n_train * 2 * L + n_eval * L
        fused_v = spmm.variant_name(torch.float32, True, True)
        gather_v = spmm.variant_name(torch.float32, True, False)
        expect_v = {fused_v: (n_train + n_eval) * L, gather_v: n_train * L}
        check(len(rows) == 1, f"expected one epoch, got {len(rows)}")
        row = rows[0]
        losses = np.asarray(row["step_losses"])
        log(f"[train] 1 epoch in {train_s:.1f} s: {len(losses)} steps, "
            f"train_loss {row['train_loss']:.5f} val_loss "
            f"{row['val_loss']:.5f} test MAE {mae:.5f}; kernel launches "
            f"{launches} (expected {expect}): {path_launches}")
        check(len(losses) == n_train, f"{len(losses)} train steps")
        check(np.isfinite(losses).all() and math.isfinite(mae)
              and math.isfinite(row["val_loss"]), "non-finite loss")
        check(launches == expect and path_launches == expect_v,
              f"kernel launches {launches} {path_launches} != {expect} "
              f"{expect_v} (per train step L fused forward + L gather "
              f"backward, per eval step L fused forward)")

        def first_step_loss(cfg, batch, device, loss):
            """The trainer's first-step loss before its update: the model
            initialized from SEED on the CPU, moved to ``device``; this
            launches no kernel (the CPU takes the plain version, COO has
            no kernel)."""
            model = init_parameters(make_model(cfg), SEED).to(device)
            b = batch.to(device)
            with torch.no_grad():
                (lsum, cnt), v = launched(spmm, lambda: _masked_loss(
                    model(b, train=True), b.y, b.graph_mask, loss))
            check(not v, f"a first step on {device} launched {v}")
            return float(lsum / cnt)

        def same_first_step(label, got, cfg, pallas_loader, coo_loader,
                            loss):
            """The path's first-step loss against the same step on the CPU
            (plain version) and on --backend coo on the card."""
            cpu_loss = first_step_loss(cfg, first_batch(pallas_loader),
                                       "cpu", loss)
            coo_loss = first_step_loss(cfg, first_batch(coo_loader), dev,
                                       loss)
            rel_cpu = abs(got - cpu_loss) / abs(cpu_loss)
            rel_coo = abs(got - coo_loss) / abs(coo_loss)
            log(f"[{label}] first-step loss GPU {got:.7f}, CPU "
                f"{cpu_loss:.7f} (rel diff {rel_cpu:.2e}), --backend coo on "
                f"the card {coo_loss:.7f} (rel diff {rel_coo:.2e})")
            check(rel_cpu <= 1e-4 and rel_coo <= 1e-4,
                  f"{label}: first-step loss differs by {rel_cpu:.2e} (CPU), "
                  f"{rel_coo:.2e} (coo) > 1e-4")

        same_first_step("train", losses[0], mcfg, tl,
                        GraphLoader(tl.graphs, BATCH, shuffle=True,
                                    seed=SEED, mode="coo"), "l1")

        # ---- 4. the CSL slice: train_csl at the reference width ----
        rows_c = []
        spmm.reset_launch_counts()
        t0 = time.perf_counter()
        acc = train_csl.main(
            csl_argv(os.path.join(work, "csl"), "cuda", "pallas"),
            epoch_callback=lambda e, m, row: rows_c.append(row))
        torch.cuda.synchronize()
        csl_launches = dict(spmm.gather_segment_sum.variant_launches)
        csl_w = Counter(spmm.gather_segment_sum.width_launches)
        csl_s = time.perf_counter() - t0
        n_tr = CSL_EPOCHS * math.ceil(len(tr) / CSL_BATCH)
        n_ev = (CSL_EPOCHS * math.ceil(len(va) / CSL_BATCH)
                + sum("test_loss" in r for r in rows_c)
                * math.ceil(len(te) / CSL_BATCH))
        expect_c = {fused_v: (n_tr + n_ev) * CSL_L, gather_v: n_tr * CSL_L}
        closses = np.concatenate([r["step_losses"] for r in rows_c])
        log(f"[csl] {CSL_EPOCHS} epochs of fold 0 in {csl_s:.1f} s: "
            f"{len(closses)} train steps, {n_ev} eval steps, train_loss "
            + ", ".join(f"{r['train_loss']:.5f}" for r in rows_c)
            + ", val_accuracy " + ", ".join(f"{r['val_accuracy']:.3f}"
                                            for r in rows_c)
            + f", test accuracy {acc:.3f}; kernel launches {csl_launches} "
            f"(expected {expect_c})")
        check(len(rows_c) == CSL_EPOCHS and len(closses) == n_tr,
              f"{len(rows_c)} epochs, {len(closses)} train steps")
        check(np.isfinite(closses).all()
              and all(math.isfinite(r["val_loss"]) for r in rows_c),
              "csl: non-finite loss")
        check(csl_launches == expect_c,
              f"csl kernel launches {csl_launches} != {expect_c} (per train "
              f"step L fused forward + L gather backward, per eval step L "
              f"fused forward)")
        same_first_step("csl", float(closses[0]), cmcfg, ctl, coo_tl,
                        "cross_entropy")

        # ---- 5. the other families, one step at CSL width ----
        cb = cfb.to(dev)
        fam_launches = Counter()
        fam_w0 = Counter(spmm.gather_segment_sum.width_launches)

        def step_grads(model, batch, lr, wd):
            """(loss, {parameter: grad}, launches) of one AdamW step."""
            (lsum, cnt), v = launched(spmm, lambda: train_step(
                model, make_optimizer(model.parameters(), lr, wd), batch,
                "cross_entropy"))
            return (float(lsum / cnt),
                    {n: p.grad for n, p in model.named_parameters()}, v)

        def ulp_moved(model):
            """model with every weight moved by an ulp, w * (1 +- 2**-23)."""
            g = torch.Generator().manual_seed(1)
            with torch.no_grad():
                for p in model.parameters():
                    sign = torch.randint(0, 2, p.shape, generator=g) * 2 - 1
                    p.mul_(1.0 + sign.to(p.dtype) * 2.0 ** -23)
            return model

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
            hp = (fargs.lr, fargs.l2_wd)
            loss_c, grads, v_c = step_grads(
                init_parameters(make_model(fcfg), SEED), cfb, *hp)
            loss_u, grads_u, _ = step_grads(
                ulp_moved(init_parameters(make_model(fcfg), SEED)), cfb, *hp)
            loss_g, grads_g, v_g = step_grads(
                init_parameters(make_model(fcfg), SEED).to(dev), cb, *hp)
            torch.cuda.synchronize()
            fam_launches.update(v_g)
            rel = abs(loss_g - loss_c) / abs(loss_c)
            rel_u = abs(loss_u - loss_c) / abs(loss_c)
            gscale = max(float(g.abs().max()) for g in grads.values()
                         if g is not None)
            leaves = []         # (err / leaf scale, err / tol, name, ...)
            for n, want in grads.items():
                check((grads_g[n] is None) == (want is None),
                      f"{name}: {n} has a gradient on one device only")
                if want is None:
                    continue
                got = grads_g[n].cpu()
                scale = float(want.abs().max())
                ulp = float((grads_u[n] - want).abs().max())
                atol = 1e-4 * scale + 8 * ulp + 1e-7 * gscale
                err = (got - want).abs()
                leaves.append((float(err.max()) / max(scale, 1e-30),
                               float((err / (atol + 1e-4 * want.abs())).max()),
                               n, float(err.max()), scale, ulp))
                torch.testing.assert_close(
                    got, want, rtol=1e-4, atol=atol,
                    msg=lambda m: f"{name} d{n}: {m}")

            def leaf(t):
                return (f"{t[2]} (|err| {t[3]:.2e}, leaf max {t[4]:.2e}, "
                        f"ulp-moved {t[5]:.2e}, err/tol {t[1]:.2f})")
            log(f"[families] {name}: loss GPU {loss_g:.7f} CPU {loss_c:.7f} "
                f"(rel diff {rel:.2e}; the CPU's with every weight moved by "
                f"an ulp {rel_u:.2e}); {len(leaves)} gradients, largest "
                f"{gscale:.2e}; worst by |err| / leaf max: "
                f"{leaf(max(leaves))}; worst by |err| / tol: "
                f"{leaf(max(leaves, key=lambda t: t[1]))}; kernel launches "
                f"{v_g} (expected {expect})")
            check(not v_c, f"{name}: the CPU step launched {v_c}")
            check(rel <= 1e-4, f"{name}: loss differs by {rel:.2e} > 1e-4")
            check(v_g == expect, f"{name}: launches {v_g} != {expect}")
        fam_w = Counter(spmm.gather_segment_sum.width_launches)
        fam_w.subtract(fam_w0)

        # ---- 6. times, on the flagship k=8 plan ----
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

        # ---- the same times at the CSL shapes ----
        def csl_times(sub, D, label):
            """The f32 variants where the CSL path launches them over this
            plan (the fused form over fwd, the gather over bwd) and the
            gather over fwd beside torch.sparse.mm; returns the fused
            form's inputs and times."""
            t1c = torch.randn(sub.counts1.shape[1], D, device=dev,
                              generator=gen)
            tkc = (torch.randn(cvk, D, device=dev, generator=gen)
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

        _, _, gt = csl_times(c1, CSL_H, "csl k=1 (GINE)")
        xf, kw, ct = csl_times(cplan, CSL_H // CSL_K, f"csl k={CSL_K}")
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
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(set(errs) == set(variants),
          f"variants checked {sorted(errs)} != {sorted(variants)}")
    # launches of every path: the flagship, CSL and family runs
    all_launches = Counter(path_launches) + Counter(csl_launches) \
        + fam_launches
    all_w = path_w + csl_w + fam_w
    # the main path's widths, each timed on the CSR where it launches
    shapes = [(f"flagship k={K} plan", H, times[fused_v], times[gather_v]),
              (f"csl k={CSL_K} plan", CSL_H // CSL_K, ct[fused_v, "fwd"],
               ct[gather_v, "bwd"]),
              ("csl k=1 slice (GINE)", CSL_H, gt[fused_v, "fwd"],
               gt[gather_v, "bwd"])]
    check(set(all_w) <= {(v, D) for _, D, _, _ in shapes
                         for v in (fused_v, gather_v)},
          f"the paths launched {dict(all_w)}, outside the timed widths")
    entries = [dict(name=vname, **KERNEL, launches=all_launches.get(vname, 0),
                    max_abs_err=errs[vname], ms=ms, plain_ms=plain,
                    bound_ms=bound, bound_by=by, library_ms=lib)
               for vname, (ms, plain, lib, bound, by) in times.items()]
    for label, D, t_fused, t_gather in shapes:
        for vname, (ms, plain, lib, bound, by) in ((fused_v, t_fused),
                                                   (gather_v, t_gather)):
            entries.append(dict(
                name=f"{vname} D={D}", **KERNEL, shape=f"{label}, D={D}",
                launches=all_w[vname, D], max_abs_err=errs_w[vname, D],
                ms=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=lib))
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
