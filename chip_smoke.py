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
     the same step on the CPU;
  4. time   — on the flagship k=8 plan (CUDA events, after warm-up,
     rotating distinct inputs), each beside the least time the card could
     take: every kernel variant on the CSR where the main path launches it
     (the gather over the backward CSR, the fused form over the forward
     one), its plain version and, for the gather, one ``torch.sparse.mm``
     call; the gather over the forward CSR likewise; the unfused
     composition the fused forward replaces (kernel + k ``counts @ table``
     GEMMs + stack + add); and the flagship train step, with its device
     time by kernel from torch.profiler.
The last lines are the card's name and power limit, a ``kernels`` JSON
line (one entry per kernel variant), and ``{"ok": true, "device": {...}}``.

Tolerances: f32 gather vs plain version atol 1e-5, except the hub row,
whose 10k-term sums may differ in summation order by up to 1e-6 of the
row's sum of |x| (plus 1e-5); the fused forward likewise 1e-5 plus 1e-6
of its sum of |terms| (the kernel adds x and table rows edge by edge,
the plain version per edge pair); the table gradients, sums over the n
rows of the counts (a matmul against an atomic scatter in varying
order), 1e-5 plus 2*sqrt(n)*2**-24 of their sum of |terms|, the
probabilistic bound of f32 summation error; bf16 input vs the plain
version on the same bf16 values, both summed in f32, rtol 1e-3; first
train-step loss GPU vs CPU rtol 1e-4.
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


def profile_step(torch, step, step_ms, steps=3):
    """Device time per train step by kernel (torch.profiler) and the
    device's idle share against the unprofiled step time."""
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
        log("[profile] train step: device time not measured (the profiler "
            "recorded no kernel)")
        return
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
    log(f"[profile] train step: device busy {busy_ms:.3f} ms of "
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
    from kpgnn_tpu_torch.data.molecules import load_zinc
    from kpgnn_tpu_torch.models.factory import make_model
    from kpgnn_tpu_torch.nn.inits import init_parameters
    from kpgnn_tpu_torch.ops import cuda_lib, spmm
    from kpgnn_tpu_torch.scripts import common, train_zinc
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

        # ---- 2. kernels against their plain versions ----
        gen = torch.Generator(device=dev).manual_seed(0)
        errs = Counter()            # variant -> max |err| over its checks
        f32_tol = dict(rtol=0.0, atol=1e-5)

        def note(variants, err):
            for v in variants:
                errs[v] = max(errs[v], err)

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
                note(v_f, ef)
                note(set(v_b) | set(v_g), eb)
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

        def compare_fused(name, sub, D, dtype=torch.float32, mis=False):
            """The fused forward (gather + edge-embedding term) and its
            autograd grads of x and both tables against the plain version's
            autograd."""
            k, f, n = sub.K, sub.fwd, sub.counts1.shape[0]
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
                     (v_b if what == "dx" else ()), err)
            log(f"[check] fused {name}: D {D} {str(dtype)[6:]}: max |err| "
                + ", ".join(msg) + f"; {expect_f} + {expect_b}")

        for k in range(1, K + 1):
            compare_fused(f"flagship k={k}", plan.slice_hops(k), H)
        compare_fused(f"flagship k={K} bf16", plan, H, dtype=torch.bfloat16)
        compare_fused(f"flagship k={K} misaligned", plan, H, mis=True)
        compare_fused(f"flagship k={K} bf16 misaligned", plan, H,
                      dtype=torch.bfloat16, mis=True)
        compare_fused(f"flagship k={K} D=13", plan, 13)

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

        # the same first step on the CPU, through the plain version
        it = iter(tl)
        first = next(it)
        it.close()
        cpu_model = init_parameters(make_model(mcfg), SEED)
        before = dict(spmm.gather_segment_sum.variant_launches)
        with torch.no_grad():
            pred = cpu_model(first, train=True)
            lsum, cnt = _masked_loss(pred, first.y, first.graph_mask, "l1")
        cpu_loss = float(lsum / cnt)
        check(dict(spmm.gather_segment_sum.variant_launches) == before,
              "the CPU step launched the kernel")
        rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
        log(f"[train] first-step loss GPU {losses[0]:.7f} CPU "
            f"{cpu_loss:.7f} (rel diff {rel:.2e})")
        check(rel <= 1e-4, f"first-step loss differs by {rel:.2e} > 1e-4")

        # ---- 4. times, on the flagship k=8 plan ----
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
            bound, by = kernel_bound_ms(csr, H, inputs[0].element_size(),
                                        bool(kw))
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
        for _ in range(3):
            train_step(model, opt, batch)
        torch.cuda.synchronize()
        steps = 10
        t0 = time.perf_counter()
        for _ in range(steps):
            train_step(model, opt, batch)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) / steps * 1e3
        log(f"[time] flagship train step {step_ms:.2f} ms, "
            f"{union_edges / step_ms / 1e3:.3f}M union edges/s "
            f"({union_edges} union edges, batch {BATCH})")
        profile_step(torch, lambda: train_step(model, opt, batch), step_ms)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    check(set(errs) == set(variants),
          f"variants checked {sorted(errs)} != {sorted(variants)}")
    log(card)
    log(json.dumps({"kernels": [dict(
        name=vname, **KERNEL, launches=path_launches.get(vname, 0),
        max_abs_err=errs[vname], ms=ms, plain_ms=plain, bound_ms=bound,
        bound_by=by, library_ms=lib)
        for vname, (ms, plain, lib, bound, by) in times.items()]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
