"""Banded-backend tile sweep on the card (counterpart of
kpgnn_tpu/scripts/tune_banded.py).

Times the hop-major banded aggregation (``ops.banded``), forward and
forward + backward, for each receiver tile on the large-graph polymer
workload (``synthetic_polymers``: --batch graphs of --n_nodes nodes,
K hops, width D), by ``utils.timing.chained_throughput``: --chain
dependent applications a call, so the rate is one application's.  The
halo is auto-sized per plan, so the swept variable is the trade between
the rows each tile multiplies (win = tile + 2·halo) and the size of the
batched products.  Prints one JSON row per tile (union edges per second
forward and forward + backward, halo, win, n_pad, spill length), then
the best tile by the forward + backward rate.  ``--device`` defaults to
cuda (without CUDA it raises unless ``--device cpu`` is given).

    python -m kpgnn_tpu_torch.scripts.tune_banded --tiles 128,256,512
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.synthetic import synthetic_polymers
from ..graph.batch import collate, collate_banded
from ..ops.banded import banded_khop_aggregate
from ..train.loop import resolve_device
from ..utils.timing import chained_throughput
from .common import set_full_f32

V1, VK = 5, 32          # num_hop1_edge + 2, max_pe_num + 2 of the model


def main(argv=None):
    """Returns {tile: its JSON row} and prints the rows and the best."""
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--n_nodes", type=int, default=8192)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--K", type=int, default=3)
    p.add_argument("--hidden_size", type=int, default=102)
    p.add_argument("--iters", type=int, default=96)
    p.add_argument("--chain", type=int, default=8)
    p.add_argument("--tiles", default="128,256,512")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA the run raises unless "
                        "--device cpu is given")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    set_full_f32()

    graphs = synthetic_polymers(args.batch, args.n_nodes, K=args.K, seed=0)
    union_edges = int(collate(graphs).adj.edge_mask.sum())
    rng = np.random.default_rng(0)
    D = args.hidden_size

    results = {}
    for tile_s in args.tiles.split(","):
        tile = int(tile_s)
        adj = collate_banded(graphs, v1=V1, vk=VK, tile=tile).adj
        n = adj.n_nodes
        adj = adj.to(device)
        x0, t1, tk = (torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(device)
            for shape in ((args.K, n, D), (V1, D), (VK, D)))

        def fwd_chain(x, adj=adj):
            for _ in range(args.chain):
                x = banded_khop_aggregate(x, t1, tk, adj, hop_major=True)
            return x

        def fwdbwd_chain(x, adj=adj):
            x = x.detach().requires_grad_(True)
            (fwd_chain(x, adj) ** 2).sum().backward()
            return x.grad

        with torch.no_grad():
            f = chained_throughput(fwd_chain, x0, union_edges, args.iters,
                                   args.chain)
        fb = chained_throughput(fwdbwd_chain, x0, union_edges, args.iters,
                                args.chain)
        row = {
            "fwd_edges_per_s": round(f, 1),
            "fwdbwd_edges_per_s": round(fb, 1),
            "halo": adj.halo,
            "win": tile + 2 * adj.halo,
            "n_pad": n,
            "spill": (0 if adj.spill_senders is None
                      else int(adj.spill_senders.shape[0])),
        }
        results[tile_s] = row
        print(json.dumps({"tile": tile, **row}), flush=True)

    best = max(results, key=lambda t: results[t]["fwdbwd_edges_per_s"])
    print(json.dumps({"best_tile": int(best), **results[best]}), flush=True)
    return results


if __name__ == "__main__":
    main()
