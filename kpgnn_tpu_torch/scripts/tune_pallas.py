"""Plan-shape and variant sweep of the gather kernel on the card
(counterpart of kpgnn_tpu/scripts/tune_pallas.py).

The JAX tuner sweeps the TPU kernel's grid (tile_r x wblock x egroup).
The Hopper kernel (csrc/gather_segment_sum.cu) has no launch knob: its
grid follows from the plan, so this sweeps what a run does choose, the
plan's shape (``--batch_size``, a comma list: one flagship-shaped batch
of ``synthetic_molecules`` a size, collated once) and the kernel's form
(``gather``, the bare kernel, and ``fused``, the gather plus the
edge-embedding rows that the model's forward launches).  For each point
it times, by ``utils.timing.chained_throughput`` (--chain
dependent applications a call, so the rate is one application's), the
form over the forward CSR on the hop-major (K·n, D) table and a forward
+ backward chain through ``ops.spmm._GatherSegment`` or ``_FusedKHop``
(``chain`` forward and ``chain`` transpose launches, all dependent; the
tables take no gradient).  Prints one JSON row per point (union
edges per second forward and forward + backward, n_pad, and the forward
CSR's rows with an edge and largest row, in place of the TPU plan's
max_wblocks / max_chunks), then the best point by the forward + backward
rate.  ``--device`` defaults to cuda (without CUDA it raises unless
``--device cpu`` is given; the CPU runs the plain version, whose rate
says nothing of the kernel).

    python -m kpgnn_tpu_torch.scripts.tune_pallas
    python -m kpgnn_tpu_torch.scripts.tune_pallas --K 2 --hidden_size 16 \\
        --batch_size 64,128,256
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.synthetic import synthetic_molecules
from ..graph.batch import collate, collate_pallas
from ..ops.spmm import _FusedKHop, _GatherSegment
from ..prep.khop import KHopConfig
from ..train.loop import resolve_device
from ..utils.timing import chained_throughput
from .common import set_full_f32

V1, VK = 5, 32          # the JAX tuner's hop-1 / hop-k attr vocabularies
VARIANTS = ("gather", "fused")


def main(argv=None):
    """Returns {point: its JSON row} and prints the rows and the best."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--K", type=int, default=8)
    p.add_argument("--hidden_size", type=int, default=104)
    p.add_argument("--batch_size", default="64",
                   help="graphs a batch; a comma list sweeps plan shapes")
    p.add_argument("--iters", type=int, default=96)
    p.add_argument("--chain", type=int, default=8,
                   help="dependent applications a timed call")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA the run raises unless "
                        "--device cpu is given")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_full_f32()
    D = args.hidden_size

    kcfg = KHopConfig(K=args.K, kernel="spd", max_edge_attr_num=30,
                      max_hop_num=6, max_edge_type=3, max_edge_count=20,
                      max_distance_count=30)
    rng = np.random.default_rng(0)

    def table(rows):
        return torch.from_numpy(rng.normal(size=(rows, D)).astype(
            np.float32)).to(device)

    results = {}
    for bs in (int(b) for b in args.batch_size.split(",")):
        graphs = synthetic_molecules(bs, kcfg, seed=0)
        union_edges = int(collate(graphs).adj.edge_mask.sum())
        b = collate_pallas(graphs, v1=V1, vk=VK)
        plan = b.adj.to(device)
        n = b.x.shape[0]
        x0 = table(args.K * n)
        t1 = table(plan.counts1.shape[1])
        tk = (table(plan.countsk_hm.shape[2]) if plan.countsk_hm is not None
              else None)
        deg = plan.fwd.indptr[1:] - plan.fwd.indptr[:-1]
        shape = {"n_pad": n, "live_rows": int((deg > 0).sum()),
                 "max_row_nnz": int(deg.max())}
        for variant in VARIANTS:
            fused = variant == "fused"
            tables = (dict(codes=plan.fwd.codes, table1=t1, tablek=tk)
                      if fused else {})

            def fwd_chain(x, plan=plan, tables=tables):
                for _ in range(args.chain):
                    x = plan.fwd.gather(x, **tables)
                return x

            def fwdbwd_chain(x, plan=plan, fused=fused):
                x = x.detach().requires_grad_(True)
                y = x
                for _ in range(args.chain):
                    y = (_FusedKHop.apply(y, t1, tk, plan) if fused else
                         _GatherSegment.apply(y, plan.fwd, plan.bwd))
                (y * y).sum().backward()
                return x.grad

            with torch.no_grad():
                f = chained_throughput(fwd_chain, x0, union_edges,
                                       args.iters, args.chain)
            fb = chained_throughput(fwdbwd_chain, x0, union_edges,
                                    args.iters, args.chain)
            point = f"{variant}/{bs}"
            row = {"variant": variant, "batch_size": bs,
                   "fwd_edges_per_s": round(f, 1),
                   "fwdbwd_edges_per_s": round(fb, 1), **shape}
            results[point] = row
            print(json.dumps({"point": point, **row}), flush=True)

    best = max(results, key=lambda pt: results[pt]["fwdbwd_edges_per_s"])
    print(json.dumps({"best_point": best, **results[best]}), flush=True)
    return results


if __name__ == "__main__":
    main()
