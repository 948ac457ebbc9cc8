"""The BiLSTM kernels' bias gradient against float64 over seeds, on the
card, beside two witnesses of how far a correct long sum strays.

For each (T, H, dtype, B) and seed: the inputs of
tests/test_torch_lstm_cuda.py (a 1/256 grid in (-1, 1), exact in bf16)
from that seed, and the error from float64 of db_hh (the bias gradient,
a sum of T * B gate gradients) by

- ``kernel``: the kernels (``lstm.recurrence``),
- ``plain``: the plain version on the card (``recurrence_reference``
  under autograd, the card test's yardstick),
- ``cpu``: the plain version on the CPU (the same ops, rounded by other
  kernels),
- ``plain_dz``: the float64 sum of the card plain version's own gate
  gradients (dxm), which takes its long sum out of its error,
- ``chain``: backpropagation in float64 from the activations, cell and
  hidden states the forward gives in the dtype (a backward that rounds
  nothing past the forward).

For each it counts the card test's gate against ``plain`` (error at
most twice the plain version's plus one ulp of the dtype at the
output's scale), the same for dW_hh (kernel and cpu), and reports the
coherence of the gate gradients' errors, |sum of errors| / sum of
|errors| for each of dxm's 8H columns (the largest), which a bias
pushes towards 1.  y is also compared bit for bit with the plain
version's, and the share of dxm's elements equal to the plain
version's is given.  One JSON line per
(case, seed) goes to --out; a summary is printed.

    python -m kpgnn_tpu_torch.scripts.lstm_db_spread --seeds 6 \\
        --out chiprun_out/lstm_db_spread.jsonl
"""
from __future__ import annotations

import argparse
import collections
import json
import time

import numpy as np
import torch

from ..ops import lstm
from ..train.loop import resolve_device

ULP = {torch.float32: 2.0 ** -23, torch.bfloat16: 2.0 ** -8}
WITNESSES = ("kernel", "cpu", "plain_dz", "chain")


def grid_inputs(T, B, H, seed):
    """xm (T, B, 8H), w_hh (2, 4H, H), b_ih (8H,), b_hh (2, 4H) and dy (T,
    B, 2H) on a 1/256 grid in (-1, 1), float64 on the CPU (the card
    test's inputs)."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(np.round(rng.uniform(-1, 1, s) * 255) / 256)
            for s in ((T, B, 8 * H), (2, 4 * H, H), (8 * H,), (2, 4 * H),
                      (T, B, 2 * H))]


def run(fn, xm, w_hh, b_ih, b_hh, dy):
    """(y, dxm, db_hh, dw_hh) of ``fn`` under autograd."""
    leaves = [t.clone().requires_grad_() for t in (xm, w_hh, b_ih, b_hh)]
    y = fn(*leaves)
    y.backward(dy.to(y.dtype))
    return y.detach(), leaves[0].grad, leaves[3].grad, leaves[1].grad


def f64_chain(xm, w_hh, b_ih, b_hh, dy):
    """(dxm, db) by backpropagation in float64 from the forward's
    activations, cell and hidden states in xm's dtype."""
    H = w_hh.shape[2]
    with torch.no_grad():
        acts, cs, hs = lstm._run_reference(xm, w_hh, b_ih, b_hh)
        w = w_hh.double()
        dys = torch.stack([dy[:, :, :H], dy.flip(0)[:, :, H:]], 1).double()
        zero = torch.zeros(hs[0].shape, dtype=torch.float64,
                           device=xm.device)
        dh = dc = zero
        db = torch.zeros(2, 4 * H, dtype=torch.float64, device=xm.device)
        dzs = [None] * len(hs)
        for s in reversed(range(len(hs))):
            i, f, g, o = (a.double() for a in acts[s])
            c_prev = cs[s - 1].double() if s else zero
            dh_s = dys[s] + dh
            tc = torch.tanh(cs[s]).double()     # rounded as the forward's
            dc_s = dc + dh_s * o * (1 - tc * tc)
            dz = torch.cat([dc_s * g * i * (1 - i),
                            dc_s * c_prev * f * (1 - f),
                            dc_s * i * (1 - g * g),
                            dh_s * tc * o * (1 - o)], -1)
            dc = dc_s * f
            dh = torch.bmm(dz, w)
            db += dz.sum(1)
            dzs[s] = dz
    return lstm._time_order(dzs), db


def coherence(dxm, exact):
    """The largest over dxm's columns of |sum of errors| / sum of
    |errors| (0 where a column has no error)."""
    err = (dxm.double() - exact).flatten(0, 1)
    tot = err.abs().sum(0)
    return float(torch.where(tot > 0, err.sum(0).abs() / tot.clamp_min(
        1e-300), torch.zeros_like(tot)).max())


def one(T, B, H, dtype, seed, dev):
    """The JSON row of one (case, seed)."""
    cpu = grid_inputs(T, B, H, seed)
    exact = run(lstm.recurrence_reference, *(t.to(dev) for t in cpu))
    cast = [t.to(dev, dtype) for t in cpu]
    plain = run(lstm.recurrence_reference, *cast)
    got = run(lstm.recurrence, *cast)
    on_cpu = run(lstm.recurrence_reference, *(t.to(dtype) for t in cpu))
    chain_dxm, chain_db = f64_chain(*cast)
    e = exact[2]
    dbs = {"plain": plain[2], "kernel": got[2], "cpu": on_cpu[2].to(dev),
           "plain_dz": plain[1].double().sum((0, 1)).view(2, -1),
           "chain": chain_db}
    err = {k: float((v.double() - e).abs().max()) for k, v in dbs.items()}
    ulp = ULP[dtype] * float(e.abs().max())
    dw_err = {k: float((v[3].to(dev).double() - exact[3]).abs().max())
              for k, v in (("plain", plain), ("kernel", got),
                           ("cpu", on_cpu))}
    dw_ulp = ULP[dtype] * float(exact[3].abs().max())
    row = dict(T=T, B=B, H=H, dtype=str(dtype).split(".")[1], seed=seed,
               ulp=ulp, err=err, dw_err=dw_err,
               dw_passes={k: dw_err[k] <= 2 * dw_err["plain"] + dw_ulp
                          for k in ("kernel", "cpu")},
               passes={k: err[k] <= 2 * err["plain"] + ulp
                       for k in WITNESSES},
               coherence={"kernel": coherence(got[1], exact[1]),
                          "plain": coherence(plain[1], exact[1]),
                          "chain": coherence(chain_dxm, exact[1])},
               y_equal=bool(torch.equal(got[0], plain[0])),
               dxm_equal=float((got[1] == plain[1]).double().mean()))
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", default="1,2,8,9,16,17")
    p.add_argument("--hidden", default="1,2,3,4,5,6,8,9,16")
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA the run raises unless "
                        "--device cpu is given (the kernels need a card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows, t0 = [], time.perf_counter()
    out = open(args.out, "w") if args.out else None
    for dtype in (torch.float32, torch.bfloat16):
        for T in map(int, args.steps.split(",")):
            for H in map(int, args.hidden.split(",")):
                cap = next(c for c in (2, 4, 8, 16) if H <= c)
                for B in sorted({7, 64 // cap + 1, 128 // cap + 1, 4095}):
                    for seed in range(args.seeds):
                        row = one(T, B, H, dtype, seed, dev)
                        rows.append(row)
                        if out:
                            out.write(json.dumps(row) + "\n")
    if out:
        out.close()
    summary = {}
    for dt in ("float32", "bfloat16"):
        sel = [r for r in rows if r["dtype"] == dt]
        fails = {k: sum(not r["passes"][k] for r in sel) for k in WITNESSES}
        ratio = {k: float(np.median([r["err"][k] / max(r["err"]["plain"],
                                                        1e-300)
                                     for r in sel])) for k in WITNESSES}
        worst = {k: max((r["err"][k] - r["ulp"]) / max(r["err"]["plain"],
                                                         1e-300)
                        for r in sel) for k in WITNESSES}
        coh = {k: float(np.median([r["coherence"][k] for r in sel]))
               for k in ("kernel", "plain", "chain")}
        seeds_failing = collections.Counter(
            (r["T"], r["H"], r["B"]) for r in sel if not r["passes"]["kernel"])
        summary[dt] = dict(
            runs=len(sel), gate_fails=fails, median_err_over_plain=ratio,
            max_excess_over_plain=worst,
            median_coherence=coh,
            kernel_fails_by_case={f"T={t} H={h} B={b}": n for (t, h, b), n
                                  in sorted(seeds_failing.items())},
            dw_gate_fails={k: sum(not r["dw_passes"][k] for r in sel)
                           for k in ("kernel", "cpu")},
            y_unequal=sum(not r["y_equal"] for r in sel),
            dxm_equal_min_median=[min(r["dxm_equal"] for r in sel),
                                  float(np.median([r["dxm_equal"]
                                                   for r in sel]))])
    summary["seconds"] = time.perf_counter() - t0
    print(json.dumps(summary, indent=1))
    return summary


if __name__ == "__main__":
    main()
