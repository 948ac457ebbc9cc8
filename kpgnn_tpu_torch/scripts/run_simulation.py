"""Expressive-power collision simulation (counterpart of
kpgnn_tpu/scripts/run_simulation.py; reference: run_simulation.py).

Untrained KP-GIN embeddings of random r-regular graphs; the fraction of
node-embedding collisions is compared with the paper's theoretical bound
0.5 * log(2n) / log(r - 1) on the hops needed to distinguish nodes.  The
embeddings are forward passes only; ``--backend pallas`` runs their
aggregation through the CUDA kernel, ``--device`` defaults to cuda
(without CUDA it raises unless ``--device cpu`` is given).

    python -m kpgnn_tpu_torch.scripts.run_simulation --backend pallas
    python -m kpgnn_tpu_torch.scripts.run_simulation --backend pallas \\
        --sweep --plot_path simulation.png

``--sweep`` computes the collision rate for K = 1..4 over n = 20, 40,
80, 160 and writes the table as JSON beside ``--plot_path``
(``simulation.json``); it draws the plot too where matplotlib imports,
and logs which it did.
"""
from __future__ import annotations

import json
import math
import os
import random
from typing import Dict, List

import numpy as np
import torch

from ..data.generation import random_regular_graph
from ..models.factory import ModelConfig, make_model
from ..nn.inits import init_parameters
from ..prep.khop import KHopConfig, extract_khop
from ..train.loader import GraphLoader
from ..train.loop import resolve_device
from .common import base_parser, loader_kwargs, set_full_f32

SWEEP_NS = (20, 40, 80, 160)
SWEEP_KS = (1, 2, 3, 4)


def parser():
    p = base_parser("expressiveness simulation", model_name="KPGIN",
                    hidden_size=64, num_layer=1, K=2, max_pe_num=10)
    p.add_argument("--n", type=int, default=50)
    p.add_argument("--r", type=int, default=3)
    p.add_argument("--graphs", type=int, default=10)
    p.add_argument("--sweep", action="store_true",
                   help="sweep n and K, write the collision table as JSON "
                        "beside --plot_path, and the plot where matplotlib "
                        "imports (reference: run_simulation.py:143-162)")
    p.add_argument("--plot_path", type=str, default="simulation.png")
    return p


def generate_k_regular(n: int, r: int, count: int, seed: int) -> List[dict]:
    out = []
    for i in range(count):
        pairs = random_regular_graph(r, n, random.Random(seed + i))
        edges = pairs + [(v, u) for u, v in pairs]
        ei = np.array(sorted(edges), dtype=np.int64).T
        out.append({"num_nodes": n, "edge_index": ei,
                    "x": np.ones((n, 1), np.int64),
                    "y": np.array([0], np.int64)})
    return out


def collision_rate(embeddings, tol=1e-8) -> float:
    """The share of ordered pairs of distinct nodes whose embeddings lie
    closer than ``tol``."""
    n = embeddings.shape[0]
    d = np.linalg.norm(embeddings[:, None] - embeddings[None], axis=-1)
    coll = (d < tol).sum() - n
    return coll / (n * (n - 1))


def khop_config(K: int) -> KHopConfig:
    return KHopConfig(K=K, kernel="spd", max_edge_attr_num=10,
                      max_hop_num=1, max_edge_type=1, max_edge_count=1,
                      max_distance_count=1)


def model_config(K: int, hidden_size: int) -> ModelConfig:
    return ModelConfig(
        model_name="KPGIN", hidden_size=hidden_size, num_layer=1, K=K,
        num_hop1_edge=1, max_pe_num=10, JK="last", combine="geometric",
        virtual_node=False, wo_peripheral_edge=True,
        wo_peripheral_configuration=True, input_encoder=("embedding", 2),
        task="node_classification", output_size=hidden_size)


@torch.no_grad()
def node_embeddings(model, graph, lk: dict, device) -> np.ndarray:
    """The model's eval-mode output on the graph's real nodes."""
    b = GraphLoader([graph], 1, **lk).example().to(device)
    emb = model(b, train=False)
    return emb[b.node_mask].float().cpu().numpy()


def rates(raw, K: int, hidden_size: int, args, device) -> List[float]:
    """Each graph's collision rate under a model initialized from
    ``args.seed + i``."""
    kcfg = khop_config(K)
    mcfg = model_config(K, hidden_size)
    lk = loader_kwargs(args, mcfg)
    out = []
    for i, g in enumerate(raw):
        graph = extract_khop(g["num_nodes"], g["edge_index"], None, kcfg,
                             x=g["x"], y=g["y"])
        model = init_parameters(make_model(mcfg), args.seed + i).to(device)
        out.append(collision_rate(node_embeddings(model, graph, lk, device)))
    return out


def main(argv=None):
    """Returns the mean collision rate (with ``--sweep``, the table)."""
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    set_full_f32()
    if args.sweep:
        return sweep(args, device)
    raw = generate_k_regular(args.n, args.r, args.graphs, args.seed)
    rate = float(np.mean(rates(raw, args.K, args.hidden_size, args, device)))
    bound = 0.5 * math.log(2 * args.n) / math.log(max(args.r - 1, 2))
    print(f"n={args.n} r={args.r} K={args.K}: collision rate {rate:.4f} "
          f"(theory: K needed ~ {bound:.2f})")
    return rate


def sweep(args, device) -> Dict[str, object]:
    """Collision rate against graph size for K = 1..4 (hidden size
    rounded down to a multiple of K), against the paper's bound on hops
    needed: 0.5 * log(2n) / log(r-1).  Returns the table {"n", "r",
    "graphs", "rates": {K: [rate per n]}, "bound": [per n], "json",
    "plot"}."""
    table = {"n": list(SWEEP_NS), "r": args.r, "graphs": args.graphs,
             "rates": {}, "bound": [0.5 * math.log(2 * n)
                                    / math.log(max(args.r - 1, 2))
                                    for n in SWEEP_NS]}
    for K in SWEEP_KS:
        table["rates"][K] = [
            float(np.mean(rates(generate_k_regular(n, args.r, args.graphs,
                                                   args.seed),
                                K, args.hidden_size // K * K, args,
                                device)))
            for n in SWEEP_NS]
    table["json"] = os.path.splitext(args.plot_path)[0] + ".json"
    os.makedirs(os.path.dirname(table["json"]) or ".", exist_ok=True)
    with open(table["json"], "w") as f:
        json.dump({k: v for k, v in table.items() if k != "json"}, f,
                  indent=2)
    print(f"wrote {table['json']}")
    table["plot"] = plot(table, args.plot_path)
    return table


def plot(table, path):
    """Draws the table where matplotlib imports; returns the path written,
    or None."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib is not available: wrote the table only")
        return None
    fig, ax = plt.subplots(figsize=(6, 4))
    for K, rr in table["rates"].items():
        ax.plot(table["n"], rr, marker="o", label=f"K={K}")
    ax.set_xscale("log")
    ax.set_xlabel("graph size n (r-regular, r=%d)" % table["r"])
    ax.set_ylabel("node embedding collision rate")
    ax.legend()
    ax.set_title("untrained KP-GIN collisions "
                 "(theory: K needed ~ 0.5 log(2n)/log(r-1))")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
    print(f"wrote {path}")
    return path


if __name__ == "__main__":
    main()
