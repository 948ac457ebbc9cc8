"""Node property regression (counterpart of
kpgnn_tpu/scripts/train_node_property.py).

Tasks 0..2: sssp distance / eccentricity / Laplacian features of every
node of generated graphs of the ten families (``data/property``),
through the node regression head; MSE over the real nodes, reported as
log10(MSE); best-val epoch -> test; the plateau schedule stops a run at
min_lr.  ``--data_scale`` shrinks the generated splits.  ``--device``
defaults to cuda (without CUDA it raises unless ``--device cpu`` is
given); ``--backend pallas`` runs the aggregation through the CUDA
kernel.

    python -m kpgnn_tpu_torch.scripts.train_node_property --backend pallas \\
        --task 0 --runs 1
"""
from __future__ import annotations

import time

import numpy as np

from ..data.property import generate_property_dataset
from ..train.loop import resolve_device
from .common import (base_parser, cli, fit_runs, model_config, prepare,
                     setup_run)
from .train_graph_property import log10_mse


def parser():
    p = base_parser("node property", model_name="KPGINPlus", K=6,
                    hidden_size=128, num_layer=6, num_epochs=250,
                    batch_size=128, lr=1e-2, max_pe_num=50, max_hop_num=5,
                    max_edge_type=1, max_edge_count=50,
                    max_distance_count=100, patience=10, runs=4,
                    l2_wd=3e-7)
    p.add_argument("--task", type=int, default=0, choices=range(3))
    p.add_argument("--data_scale", type=float, default=1.0,
                   help="shrink the generated splits (smoke runs)")
    return p


def datasets(args):
    """The prepped {"train", "val", "test"} splits, y the task's node
    labels, (num_nodes, 1)."""
    data = generate_property_dataset(seed=1234, scale=args.data_scale)
    t = args.task
    for split in data.values():
        for g in split:
            g["y"] = g.pop("node_y")[:, t:t + 1].astype(np.float32)
    return {k: prepare(v, args, f"nprop_{k}_s{args.data_scale}")
            for k, v in data.items()}


def config(args):
    return model_config(args, input_encoder=("linear", 2),
                        task="node_regression", output_size=1)


def main(argv=None, epoch_callback=None):
    """Returns the mean best-val test log10(MSE) over runs.
    ``epoch_callback`` (epoch, model, row), if given, sees every epoch's
    history row."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    save_dir, logger = setup_run(args, f"nprop{args.task}")
    t0 = time.perf_counter()
    splits = datasets(args)
    logger.info(f"data: {sum(map(len, splits.values()))} graphs generated "
                f"and prepped in {time.perf_counter() - t0:.1f} s")
    scores = []
    for run, best in enumerate(fit_runs(args, splits, config(args), "mse",
                                        logger, node_level=True,
                                        epoch_callback=epoch_callback)):
        scores.append(log10_mse(best))
        logger.info(f"run {run}: test log10(MSE) {scores[-1]:.4f}")
    logger.info(f"task {args.task} log10(MSE): "
                f"{np.mean(scores):.4f} +- {np.std(scores):.4f}")
    return float(np.mean(scores))


if __name__ == "__main__":
    cli(main, parser)
