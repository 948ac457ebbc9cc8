"""ZINC-subset penalized-logP regression (counterpart of
kpgnn_tpu/scripts/train_zinc.py).

Canonical headline config: KPGINPlus K=8 L=8 h=104 --residual --JK
concat.  L1 loss, plateau LR with stop-at-min-lr, best-val -> test MAE
over runs.  The port trains on ``--backend pallas`` (the fused-hop CUDA
kernel) and on ``--device`` (default cuda; without CUDA it raises unless
``--device cpu`` is given).

    python -m kpgnn_tpu_torch.scripts.train_zinc --backend pallas \\
        --combine attention --residual --dataset_dir <dir holding ZINC/>
"""
from __future__ import annotations

import os

import numpy as np

from ..data.molecules import load_zinc
from ..train.loop import resolve_device
from .common import (base_parser, cli, fit_runs, model_config, prepare,
                     setup_run)


def parser():
    p = base_parser("ZINC regression", model_name="KPGINPlus", K=8,
                    hidden_size=104, num_layer=8, num_epochs=500,
                    batch_size=64, JK="concat", num_hop1_edge=3,
                    max_pe_num=50, max_edge_type=3, max_edge_count=50,
                    max_hop_num=6, max_distance_count=50, patience=10,
                    runs=4)
    p.add_argument("--full", action="store_true",
                   help="full 250k ZINC instead of the 12k subset")
    return p


def main(argv=None, epoch_callback=None):
    """Returns the mean best-val test MAE over runs.  ``epoch_callback``
    (epoch, model, row), if given, sees every epoch's history row."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    save_dir, logger = setup_run(args, "ZINC")

    splits = load_zinc(os.path.join(args.dataset_dir, "ZINC"),
                       subset=not args.full)
    prepped = {k: prepare(v, args, f"ZINC_{k}")
               for k, v in splits.items()}
    mcfg = model_config(args, input_encoder=("embedding", 21),
                        task="graph_regression", output_size=1)
    maes = []
    for run, best in enumerate(fit_runs(args, prepped, mcfg, "l1", logger,
                                        epoch_callback=epoch_callback)):
        maes.append(best.get("loss", float("nan")))
        logger.info(f"run {run}: test MAE {maes[-1]:.5f}")
    logger.info(f"ZINC test MAE: {np.mean(maes):.5f} +- {np.std(maes):.5f}")
    return float(np.mean(maes))


if __name__ == "__main__":
    cli(main, parser)
