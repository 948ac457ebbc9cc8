#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (kpgnn_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each of which fails the run loudly:
  1. build  — compile every CUDA kernel of the main path from this
     checkout's sources (csrc/, nvcc for sm_90a); print the card, its power
     limit and the build seconds;
  2. check  — hold each kernel against its plain PyTorch version on the
     card, forward and autograd backward: flagship plans (64 ZINC-shaped
     molecules, K=8, D=104, every hop prefix k=1..8) and edge cases
     (empty rows with null senders, a 10k-edge hub row, a rectangular
     table, D=13, bf16 input);
  3. train  — write a ZINC-format fixture (tools/make_zinc_fixture.py) and
     run ``kpgnn_tpu_torch.scripts.train_zinc.main`` at the flagship's
     full width (KPGINPlus K=8 L=8 H=104, attention combine, JK concat,
     residual, --backend pallas) for one epoch; require finite losses,
     exactly 2*L kernel launches per train step plus L per eval step, and
     a first-step loss equal to the same step on the CPU;
  4. time   — kernel forward/backward, the plain version and one
     ``torch.sparse.mm`` call on the flagship k=8 plan (CUDA events, after
     warm-up, rotating distinct inputs), each beside the least time the
     card could take; and the flagship train step, with its device time
     by kernel from torch.profiler.
The last lines are the card's name and power limit, a ``kernels`` JSON
line, and ``{"ok": true, "device": {...}}``.

Tolerances: f32 kernel vs plain version atol 1e-5, except the hub row,
whose 10k-term sums may differ in summation order by up to 1e-6 of the
row's sum of |x| (plus 1e-5); bf16 input vs the plain version on the same
bf16 values, both summed in f32, rtol 1e-3; first train-step loss GPU vs
CPU rtol 1e-4.
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

ROOT = os.path.dirname(os.path.abspath(__file__))
K, L, H, BATCH = 8, 8, 104, 64
N_TRAIN, N_VAL, N_TEST = 1024, 128, 128
SEED = 234
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_FLOPS = 67e12              # H100 SXM data sheet, f32 outside the MMA
KERNEL = dict(name="gather_segment_sum", route="cuda",
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


def kernel_bound_ms(csr, D, x_bytes):
    """Least time for one launch on this CSR's data: the rows of x that
    some edge gathers read once, indptr and senders read once, the f32
    output written once, over the HBM rate; the adds (one per gathered
    element) over the f32 rate.  Returns (ms, by)."""
    import torch
    n_rows, n_edges = csr.n_rows, csr.senders.shape[0]
    s = csr.senders
    n_read = int(torch.unique(s[(s >= 0) & (s < csr.n_cols)]).numel())
    nbytes = n_read * D * x_bytes + (n_rows + 1) * 4 + n_edges * 4 \
        + n_rows * D * 4
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = n_edges * D / F32_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


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
    log(f"[build] {kind} ({card}); nvcc seconds: {json.dumps(secs)}")

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
        log(f"[plan] flagship batch: {int(fb.node_mask.sum())} nodes, "
            f"n_pad {fb.n_pad}, {union_edges} union edges, K*n_pad = "
            f"{plan.fwd.n_rows} rows, {plan.fwd.senders.shape[0]} live "
            "hop edges")

        # ---- 2. kernel against its plain version ----
        gen = torch.Generator(device=dev).manual_seed(0)
        errs = {}

        def compare(name, fwd, bwd, D, dtype=torch.float32, hub=False):
            x = torch.randn(fwd.n_cols, D, device=dev, generator=gen
                            ).to(dtype)
            w = torch.randn(fwd.n_rows, D, device=dev, generator=gen)
            # kernel: forward over fwd, autograd backward over bwd
            xk = x.clone().requires_grad_(True)
            out = spmm._GatherSegment.apply(xk, fwd, bwd)
            (out * w).sum().backward()
            out = out.detach()
            grad_k = spmm.gather_segment_sum(w, bwd.indptr, bwd.senders,
                                             bwd.n_rows)
            check(xk.grad.dtype == dtype
                  and torch.equal(xk.grad, grad_k.to(dtype)),
                  f"{name}: autograd backward is not the kernel over bwd")
            # plain version: forward on the same values, f32 gradient
            ref = spmm.gather_segment_sum_reference(
                x, fwd.indptr, fwd.senders, fwd.n_rows)
            xr = x.float().clone().requires_grad_(True)
            (spmm.gather_segment_sum_reference(
                xr, fwd.indptr, fwd.senders, fwd.n_rows) * w).sum().backward()
            torch.cuda.synchronize()
            check(out.dtype == torch.float32 and out.shape == ref.shape,
                  f"{name}: output {out.dtype} {tuple(out.shape)}")
            f32_tol = dict(rtol=0.0, atol=1e-5)
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
            errs[name] = (ef, eb)
            log(f"[check] {name}: rows {fwd.n_rows} cols {fwd.n_cols} "
                f"edges {fwd.senders.shape[0]} D {D} {str(dtype)[6:]}: "
                f"max |err| fwd {ef:.3e} bwd {eb:.3e}")

        for k in range(1, K + 1):
            sub = plan.slice_hops(k)
            compare(f"flagship k={k}", sub.fwd, sub.bwd, H)
        compare(f"flagship k={K} bf16", plan.fwd, plan.bwd, H,
                dtype=torch.bfloat16)

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
        # reported: the f32 flagship plans, the shapes the main path runs
        max_err = max(max(v) for k_, v in errs.items()
                      if k_.startswith("flagship") and "bf16" not in k_)

        # ---- 3. the main path: train_zinc at full width ----
        rows = []
        spmm.gather_segment_sum.launches = 0
        t0 = time.perf_counter()
        mae = train_zinc.main(
            train_argv(work, os.path.join(work, "save"), "cuda"),
            epoch_callback=lambda e, m, row: rows.append(row))
        torch.cuda.synchronize()
        launches = spmm.gather_segment_sum.launches
        train_s = time.perf_counter() - t0
        n_train = math.ceil(N_TRAIN / BATCH)
        n_eval = math.ceil(N_VAL / BATCH) + math.ceil(N_TEST / BATCH)
        expect = n_train * 2 * L + n_eval * L
        check(len(rows) == 1, f"expected one epoch, got {len(rows)}")
        row = rows[0]
        losses = np.asarray(row["step_losses"])
        log(f"[train] 1 epoch in {train_s:.1f} s: {len(losses)} steps, "
            f"train_loss {row['train_loss']:.5f} val_loss "
            f"{row['val_loss']:.5f} test MAE {mae:.5f}; kernel launches "
            f"{launches} (expected {expect})")
        check(len(losses) == n_train, f"{len(losses)} train steps")
        check(np.isfinite(losses).all() and math.isfinite(mae)
              and math.isfinite(row["val_loss"]), "non-finite loss")
        check(launches == expect,
              f"kernel launches {launches} != {expect} "
              f"(2*L per train step + L per eval step)")

        # the same first step on the CPU, through the plain version
        it = iter(tl)
        first = next(it)
        it.close()
        cpu_model = init_parameters(make_model(mcfg), SEED)
        before = spmm.gather_segment_sum.launches
        with torch.no_grad():
            pred = cpu_model(first, train=True)
            lsum, cnt = _masked_loss(pred, first.y, first.graph_mask, "l1")
        cpu_loss = float(lsum / cnt)
        check(spmm.gather_segment_sum.launches == before,
              "the CPU step launched the kernel")
        rel = abs(losses[0] - cpu_loss) / abs(cpu_loss)
        log(f"[train] first-step loss GPU {losses[0]:.7f} CPU "
            f"{cpu_loss:.7f} (rel diff {rel:.2e})")
        check(rel <= 1e-4, f"first-step loss differs by {rel:.2e} > 1e-4")

        # ---- 4. times ----
        fwd, bwd = plan.fwd, plan.bwd
        xs = [torch.randn(fwd.n_cols, H, device=dev) for _ in range(8)]
        gs = [torch.randn(bwd.n_cols, H, device=dev) for _ in range(8)]
        ms_f = time_ms(torch, lambda x: spmm.gather_segment_sum(
            x, fwd.indptr, fwd.senders, fwd.n_rows), xs)
        ms_b = time_ms(torch, lambda g: spmm.gather_segment_sum(
            g, bwd.indptr, bwd.senders, bwd.n_rows), gs)
        plain_f = time_ms(torch, lambda x: spmm.gather_segment_sum_reference(
            x, fwd.indptr, fwd.senders, fwd.n_rows), xs)
        plain_b = time_ms(torch, lambda g: spmm.gather_segment_sum_reference(
            g, bwd.indptr, bwd.senders, bwd.n_rows), gs)

        def sparse(c):
            n_e = c.senders.shape[0]
            return torch.sparse_csr_tensor(
                c.indptr.long(), c.senders.long(),
                torch.ones(n_e, device=dev), size=(c.n_rows, c.n_cols),
                check_invariants=False)
        a_f, a_b = sparse(fwd), sparse(bwd)
        lib_f = time_ms(torch, lambda x: torch.sparse.mm(a_f, x), xs)
        lib_b = time_ms(torch, lambda g: torch.sparse.mm(a_b, g), gs)
        n_e = fwd.senders.shape[0]
        bound_f, by_f = kernel_bound_ms(fwd, H, 4)
        bound_b, by_b = kernel_bound_ms(bwd, H, 4)
        log(f"[time] kernel fwd {ms_f:.4f} ms (plain {plain_f:.4f}, "
            f"torch.sparse.mm {lib_f:.4f}, bound {bound_f:.4f} by {by_f}); "
            f"bwd {ms_b:.4f} ms (plain {plain_b:.4f}, torch.sparse.mm "
            f"{lib_b:.4f}, bound {bound_b:.4f} by {by_b}); flagship k=8 "
            f"plan {fwd.n_rows} rows x D {H}, {n_e} edges; fwd "
            f"{n_e / ms_f / 1e3:.1f}M hop-edges/s")

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

    log(card)
    log(json.dumps({"kernels": [dict(
        KERNEL, launches=launches, max_abs_err=max_err, ms=ms_f,
        plain_ms=plain_f, bound_ms=bound_f, bound_by=by_f,
        library_ms=lib_f)]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
