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

``--dh_order`` instead asks in which order the card's f32 product dh =
dz @ W_hh (the plain cell's backward of ``h @ W_hh.T``: autograd's
``torch.bmm(dz, w_hh)``, (2, B, 4H) x (2, 4H, H)) sums its 4H terms: at
each hidden size the repo reaches and B from 1 to 4,097 it holds that
product, bit for bit, against each summation order of ``DH_ORDERS``
(``dh_orders``) and prints which orders it equals at each shape:

    python -m kpgnn_tpu_torch.scripts.lstm_db_spread --dh_order
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


def _chain(terms, fma):
    """One accumulator over ``terms`` ((a, b) pairs in order) from 0."""
    acc = None
    for a, b in terms:
        if acc is None:
            acc = a * b                    # fmaf(a, b, 0) rounds the same
        else:
            acc = lstm.fma_f32(a, b, acc) if fma else acc + a * b
    return acc


def _chunks(terms, n, fma=True):
    """``n`` consecutive terms an accumulator, the accumulators added in
    order."""
    parts = [_chain(terms[i:i + n], fma) for i in range(0, len(terms), n)]
    out = parts[0]
    for p_ in parts[1:]:
        out = out + p_
    return out


def _strided(terms, n, tree=False):
    """``n`` accumulators, term r into accumulator r % n (an unrolled
    loop's or a warp's lanes), then added in order or, with ``tree``, by
    halving (part i plus part i + n/2, ..., a shuffle tree's order)."""
    parts = [_chain(terms[i::n], True) for i in range(min(n, len(terms)))]
    if tree:
        while len(parts) > 1:
            half = (len(parts) + 1) // 2
            parts = [parts[i] + parts[i + half] if i + half < len(parts)
                     else parts[i] for i in range(half)]
        return parts[0]
    out = parts[0]
    for p_ in parts[1:]:
        out = out + p_
    return out


# the backward kernel's order (``lstm.dh_chain``)
KERNEL_ORDER = "the backward kernel's"
# dh[b, j] = sum over r < 4H of dz[b, r] * W[r, j]; each order is a
# function of the 4H (dz column, W row) pairs in ascending r
DH_ORDERS = {
    KERNEL_ORDER: lambda t: _chunks(t, lstm.dh_chain(len(t) // 4)),
    "fma ascending": lambda t: _chain(t, True),
    "fma descending": lambda t: _chain(t[::-1], True),
    "mul, add ascending": lambda t: _chain(t, False),
    "fma chains of 2": lambda t: _chunks(t, 2),
    "fma chains of 4": lambda t: _chunks(t, 4),
    "fma chains of 8": lambda t: _chunks(t, 8),
    "fma chains of 16": lambda t: _chunks(t, 16),
    "2 strided fma chains": lambda t: _strided(t, 2),
    "4 strided fma chains": lambda t: _strided(t, 4),
    "8 strided fma chains": lambda t: _strided(t, 8),
    "products, halving tree": lambda t: _strided(t, len(t), tree=True),
    "2 strided fma chains, halving tree": lambda t: _strided(t, 2, True),
    "4 strided fma chains, halving tree": lambda t: _strided(t, 4, True),
    "8 strided fma chains, halving tree": lambda t: _strided(t, 8, True),
    "16 strided fma chains, halving tree": lambda t: _strided(t, 16, True),
    "32 strided fma chains, halving tree": lambda t: _strided(t, 32, True),
}
# the hidden sizes the repo's combines reach (H = K), and H = 1 (JK
# attention over one layer); B = 1 no main path reaches
DH_HIDDEN = (1, 2, 3, 4, 6, 8, 16)
DH_BATCH = (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 17, 33, 64, 65, 127, 128, 255,
            256, 1000, 1024, 2048, 4095, 4096, 4097)


def dh_orders(dev, hidden=DH_HIDDEN, batches=DH_BATCH, seed=0):
    """{(H, B): {order: dh's elements that differ from the card's
    autograd product}} for f32 inputs with exponents spread over 2^-12 ..
    2^12 (so a change of order shows).  The product is the plain cell's:
    ``torch.bmm(h, w_hh.transpose(1, 2))`` differentiated by autograd at
    dz, which is ``torch.bmm(dz, w_hh)`` (checked equal)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)

    def spread(*shape):
        return (torch.randn(*shape, generator=gen)
                * torch.exp2(torch.randint(-12, 13, shape, generator=gen)
                             .float())).to(dev)
    out = {}
    for H in hidden:
        for B in batches:
            dz, w = spread(2, B, 4 * H), spread(2, 4 * H, H)
            h = torch.zeros(2, B, H, device=dev, requires_grad=True)
            got, = torch.autograd.grad(torch.bmm(h, w.transpose(1, 2)), h,
                                       dz)
            if not torch.equal(got, torch.bmm(dz, w)):
                raise AssertionError(f"H={H} B={B}: autograd's dh is not "
                                     "torch.bmm(dz, w_hh)")
            terms = [(dz[:, :, r:r + 1], w[:, r:r + 1, :])
                     for r in range(4 * H)]
            out[H, B] = {name: int((fn(terms) != got).sum())
                         for name, fn in DH_ORDERS.items()}
    return out


def dh_order_summary(unequal) -> dict:
    """The orders that equal the product at every shape, and at every
    shape with H > 1 and B > 1; the shapes with B > 1 where the kernel's
    order (``KERNEL_ORDER``) is not cuBLAS's; for each shape the orders
    it equals (none: the order with the fewest unequal elements, and
    their count)."""
    def exact_at(shapes):
        return [o for o in DH_ORDERS if all(unequal[s][o] == 0
                                            for s in shapes)]
    per = {}
    for (H, B), u in sorted(unequal.items()):
        exact = [o for o, v in u.items() if v == 0]
        best = min(u, key=u.get)
        per[f"H={H} B={B}"] = exact or [f"none (best {best}: {u[best]} "
                                        f"of {2 * B * H} unequal)"]
    return {"every_shape": exact_at(list(unequal)),
            "every_shape_H_B_over_1": exact_at(
                [s for s in unequal if s[0] > 1 and s[1] > 1]),
            "kernel_order_differs": [
                f"H={H} B={B}" for (H, B), u in sorted(unequal.items())
                if B > 1 and u[KERNEL_ORDER]],
            "per_shape": per}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", default="1,2,8,9,16,17")
    p.add_argument("--hidden", default="1,2,3,4,5,6,8,9,16")
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--out", default=None)
    p.add_argument("--dh_order", action="store_true",
                   help="only the dh summation-order probe")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA the run raises unless "
                        "--device cpu is given (the kernels need a card)")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.dh_order:
        summary = dh_order_summary(dh_orders(dev))
        print(json.dumps(summary, indent=1))
        return summary
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
