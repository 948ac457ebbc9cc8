"""EXP / CEXP 1-WL-pair discrimination (counterpart of
kpgnn_tpu/scripts/train_exp.py; reference: train_EXP.py).

Each consecutive pair of graphs is 1-WL-indistinguishable with opposite
SAT labels; a KP-GNN with adequate K must reach ~100% accuracy, so this
doubles as an expressiveness correctness check.  Contiguous block folds
keep every pair in one split; the best epoch is gated on the lowest
validation loss at a constant LR.  ``--device`` defaults to cuda (without
CUDA it raises unless ``--device cpu`` is given); ``--backend pallas``
runs the aggregation through the CUDA kernel.

    python -m kpgnn_tpu_torch.scripts.train_exp --backend pallas \\
        --dataset_dir <dir holding EXP/raw/GRAPHSAT.pkl>
    python -m kpgnn_tpu_torch.scripts.train_exp --dataset_name CEXP \\
        --dataset_dir <dir holding CEXP/GRAPHSAT.txt>
"""
from __future__ import annotations

import os

import numpy as np

from ..data.expressiveness import load_exp_pickle, load_exp_txt
from ..models.factory import make_model
from ..train.loader import GraphLoader
from ..train.loop import Trainer, resolve_device
from .common import (base_parser, cli, loader_kwargs, model_config,
                     parallel_kwargs, prepare, setup_run, train_config)


def parser():
    p = base_parser("EXP expressiveness", model_name="KPGIN", K=3,
                    hidden_size=48, num_layer=3, num_epochs=40,
                    batch_size=128, max_pe_num=1, max_edge_type=1,
                    max_edge_count=1000, max_hop_num=5,
                    max_distance_count=1000, l2_wd=3e-7,
                    matmul_precision="highest")
    p.add_argument("--dataset_name", type=str, default="EXP",
                   choices=("EXP", "CEXP"))
    p.add_argument("--folds", type=int, default=10)
    return p


def load_raw(args):
    if args.dataset_name == "EXP":
        return load_exp_pickle(
            os.path.join(args.dataset_dir, "EXP", "raw", "GRAPHSAT.pkl"))
    return load_exp_txt(
        os.path.join(args.dataset_dir, "CEXP", "GRAPHSAT.txt"))


def splits(n: int, folds: int):
    """The (train, val, test) index triples of the contiguous block folds
    (reference: train_EXP.py:260-282): fold f tests on the f-th block of
    n // folds graphs and validates on the f-th block of the rest."""
    idx = np.arange(n)
    per = n // folds
    out = []
    for fold in range(folds):
        test = idx[fold * per:(fold + 1) * per]
        rest = np.concatenate([idx[:fold * per], idx[(fold + 1) * per:]])
        vn = len(rest) // folds
        val = rest[fold * vn:(fold + 1) * vn]
        train = np.concatenate([rest[:fold * vn], rest[(fold + 1) * vn:]])
        out.append((train, val, test))
    return out


def main(argv=None, epoch_callback=None):
    """Returns the mean best-val test accuracy over the folds.
    ``epoch_callback`` (epoch, model, row), if given, sees every epoch's
    history row."""
    args = parser().parse_args(argv)
    if args.folds < 2:
        # fold f's test is 1/folds of the data and the train split is
        # the rest: folds=1 would leave the train split empty
        raise SystemExit("--folds must be >= 2")
    resolve_device(args.device)
    save_dir, logger = setup_run(args, args.dataset_name)

    graphs = prepare(load_raw(args), args, args.dataset_name)
    mcfg = model_config(args, input_encoder=("embedding", 2),
                        task="graph_classification", output_size=2)
    model = make_model(mcfg)
    lk = loader_kwargs(args, mcfg)

    accs = []
    for fold, (train, val, test) in enumerate(splits(len(graphs),
                                                     args.folds)):
        tl = GraphLoader([graphs[i] for i in train], args.batch_size,
                         shuffle=True, seed=args.seed + fold, **lk)
        vl = GraphLoader([graphs[i] for i in val], args.batch_size, **lk)
        el = GraphLoader([graphs[i] for i in test], args.batch_size, **lk)
        # best epoch gated on lowest val loss, constant LR
        # (reference: train_EXP.py:298-301; no scheduler in its loop)
        trainer = Trainer(model, train_config(args, "cross_entropy"),
                          loss="cross_entropy", metric_mode="min",
                          use_scheduler=False, logger=logger,
                          device=args.device, **parallel_kwargs(args, mcfg))
        _, res = trainer.fit(tl, vl, el, seed=args.seed + fold,
                             epoch_callback=epoch_callback)
        acc = res["best_test"].get("accuracy", 0.0)
        accs.append(acc)
        logger.info(f"fold {fold}: test acc {acc:.4f}")
    logger.info(f"{args.dataset_name}: {np.mean(accs):.4f} +- "
                f"{np.std(accs):.4f}")
    return float(np.mean(accs))


if __name__ == "__main__":
    cli(main, parser)
