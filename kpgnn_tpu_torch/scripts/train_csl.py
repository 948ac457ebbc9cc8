"""CSL circular-skip-link classification (counterpart of
kpgnn_tpu/scripts/train_csl.py).

10 isomorphism classes of C_41 + skip links, 1-WL-indistinguishable;
stratified 10-fold CV, best epoch gated on validation accuracy at a
constant LR.  The reference configuration is KPGIN on the GNN backbone,
K=4 h=48 L=4, batch 64.  ``--device`` defaults to cuda (without CUDA it
raises unless ``--device cpu`` is given); ``--backend pallas`` runs the
aggregation through the CUDA kernel, ``--backend coo`` (the default, as
in the JAX CLI) through sorted segment sums (the same kernel with
identity senders).

    python -m kpgnn_tpu_torch.scripts.train_csl --backend pallas

``--folds`` >= 3 splits the data into that many folds and runs them all,
as the JAX script does.  ``--folds`` 1 or 2, where the JAX split has no
training data, runs the first 1 or 2 folds of the standard 10-fold
split: a quick probe on the full run's splits.
"""
from __future__ import annotations

import numpy as np

from ..data.expressiveness import generate_csl
from ..models.factory import make_model
from ..train.kfold import k_fold
from ..train.loader import GraphLoader
from ..train.loop import Trainer, resolve_device
from .common import (base_parser, cli, loader_kwargs, model_config,
                     parallel_kwargs, prepare, setup_run, train_config)


def parser():
    p = base_parser("CSL expressiveness", model_name="KPGIN", K=4,
                    hidden_size=48, num_layer=4, num_epochs=200,
                    batch_size=64, max_pe_num=1000, max_hop_num=4,
                    max_edge_type=1, max_edge_count=1000,
                    max_distance_count=1000, patience=5, l2_wd=3e-6,
                    matmul_precision="highest")
    p.add_argument("--folds", type=int, default=10)
    return p


def splits(labels, folds: int, seed: int):
    """The (train, val, test) index triples the run trains on."""
    if folds >= 3:
        return k_fold(len(labels), labels, folds=folds, seed=seed)
    return k_fold(len(labels), labels, folds=10, seed=seed)[:folds]


def main(argv=None, epoch_callback=None):
    """Returns the mean best-val test accuracy over the folds.
    ``epoch_callback`` (epoch, model, row), if given, sees every epoch's
    history row."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    save_dir, logger = setup_run(args, "CSL")

    raw = generate_csl()
    for g in raw:
        g["x"] = np.ones((g["num_nodes"], 1), dtype=np.float32)
    graphs = prepare(raw, args, "CSL")
    labels = [int(g.y[0]) for g in graphs]

    mcfg = model_config(args, input_encoder=("linear", 1),
                        task="graph_classification", output_size=10)
    model = make_model(mcfg)
    lk = loader_kwargs(args, mcfg)

    accs = []
    for fold, (tr, va, te) in enumerate(splits(labels, args.folds,
                                               args.seed)):
        tl = GraphLoader([graphs[i] for i in tr], args.batch_size,
                         shuffle=True, seed=args.seed + fold, **lk)
        vl = GraphLoader([graphs[i] for i in va], args.batch_size, **lk)
        el = GraphLoader([graphs[i] for i in te], args.batch_size, **lk)
        trainer = Trainer(model, train_config(args, "cross_entropy"),
                          loss="cross_entropy", metric_mode="max",
                          use_scheduler=False, logger=logger,
                          device=args.device, **parallel_kwargs(args, mcfg))
        _, res = trainer.fit(tl, vl, el, seed=args.seed + fold,
                             epoch_callback=epoch_callback)
        acc = res["best_test"].get("accuracy", 0.0)
        accs.append(acc)
        logger.info(f"fold {fold}: test acc {acc:.4f}")
    logger.info(f"CSL: {np.mean(accs):.4f} +- {np.std(accs):.4f}")
    return float(np.mean(accs))


if __name__ == "__main__":
    cli(main, parser)
