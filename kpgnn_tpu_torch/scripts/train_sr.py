"""SR25 strongly-regular graph discrimination (counterpart of
kpgnn_tpu/scripts/train_sr.py; reference: train_SR.py).

15 SR(25,12,5,6) graphs, each its own class, train == test; evaluation
keeps batch norm in batch-statistics mode and leaves its running
statistics as they were (reference: train_SR.py:45-47).  3-WL cannot
separate these; KP-GNN with proper K and peripheral configuration can.
``--device`` defaults to cuda (without CUDA it raises unless ``--device
cpu`` is given); ``--backend pallas`` runs the aggregation through the
CUDA kernel.

    python -m kpgnn_tpu_torch.scripts.train_sr --backend pallas \\
        --dataset_dir <dir holding sr25/raw/sr251256.g6>
"""
from __future__ import annotations

import os

import numpy as np

from ..data.expressiveness import load_sr25
from ..models.factory import make_model
from ..train.loader import GraphLoader
from ..train.loop import Trainer, resolve_device
from .common import (base_parser, cli, loader_kwargs, model_config,
                     parallel_kwargs, prepare, setup_run, train_config)


def parser():
    return base_parser("SR25 expressiveness", model_name="KPGIN", K=4,
                       hidden_size=48, num_layer=4, num_epochs=200,
                       batch_size=15, lr=1e-3, max_pe_num=1000,
                       max_hop_num=4, max_edge_type=1, max_edge_count=1000,
                       max_distance_count=1000, patience=100,
                       matmul_precision="highest")


def load_raw(args):
    """The SR25 graphs with x = ones."""
    raw = load_sr25(os.path.join(args.dataset_dir, "sr25", "raw",
                                 "sr251256.g6"))
    for g in raw:
        g["x"] = np.ones((g["num_nodes"], 1), dtype=np.int64)
    return raw


def main(argv=None, epoch_callback=None):
    """Returns the best accuracy over the epochs.  ``epoch_callback``
    (epoch, model, row), if given, sees every epoch's history row."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    save_dir, logger = setup_run(args, "SR25")

    graphs = prepare(load_raw(args), args, "sr25")
    mcfg = model_config(args, input_encoder=("embedding", 2),
                        task="graph_classification", output_size=15)
    model = make_model(mcfg)
    lk = loader_kwargs(args, mcfg)

    loader = GraphLoader(graphs, args.batch_size, shuffle=True,
                         seed=args.seed, **lk)
    eval_loader = GraphLoader(graphs, args.batch_size, **lk)
    # best test accuracy over epochs, constant LR
    # (reference: train_SR.py:224-226; no scheduler in its loop)
    trainer = Trainer(model, train_config(args, "cross_entropy"),
                      loss="cross_entropy", metric_mode="max",
                      use_scheduler=False, bn_train_mode_eval=True,
                      logger=logger, device=args.device,
                      **parallel_kwargs(args, mcfg))
    _, res = trainer.fit(loader, eval_loader, eval_loader, seed=args.seed,
                         epoch_callback=epoch_callback)
    acc = res["best_val"]
    logger.info(f"SR25 accuracy: {acc:.4f}")
    return float(acc)


if __name__ == "__main__":
    cli(main, parser)
