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
from ..models.factory import make_model
from ..train.loader import GraphLoader
from ..train.loop import Trainer, resolve_device
from .common import (base_parser, loader_kwargs, model_config, prepare,
                     setup_run, train_config)


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
    prepped = {k: prepare(v, args) for k, v in splits.items()}
    mcfg = model_config(args, input_encoder=("embedding", 21),
                        task="graph_regression", output_size=1)
    lk = loader_kwargs(args, mcfg)

    maes = []
    for run in range(args.runs):
        tl = GraphLoader(prepped["train"], args.batch_size, shuffle=True,
                         seed=args.seed + run, **lk)
        vl = GraphLoader(prepped["val"], args.batch_size, **lk)
        el = GraphLoader(prepped["test"], args.batch_size, **lk)
        trainer = Trainer(make_model(mcfg),
                          train_config(args, "l1", stop_at_min_lr=True),
                          loss="l1", logger=logger,
                          device=args.device)
        _, res = trainer.fit(tl, vl, el, seed=args.seed + run,
                             epoch_callback=epoch_callback)
        mae = res["best_test"].get("loss", float("nan"))
        maes.append(mae)
        logger.info(f"run {run}: test MAE {mae:.5f}")
    logger.info(f"ZINC test MAE: {np.mean(maes):.5f} +- {np.std(maes):.5f}")
    return float(np.mean(maes))


if __name__ == "__main__":
    main()
