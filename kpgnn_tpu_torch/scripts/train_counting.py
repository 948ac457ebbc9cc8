"""Substructure counting (counterpart of
kpgnn_tpu/scripts/train_counting.py).

Tasks 0..4: triangle / tailed-triangle / 3-star / 4-cycle / custom
counts on generated Erdős–Rényi graphs (``data/counting``).  L1 on
labels divided by their std (``--ystd train``: the train split's;
``full``: the whole set's, Bessel-corrected, the reference's protocol);
best-val epoch -> test MAE; the plateau schedule stops a run at min_lr.
Run r trains from seed ``--seed`` + r.  ``--device`` defaults to cuda
(without CUDA it raises unless ``--device cpu`` is given); ``--backend
pallas`` runs the aggregation through the CUDA kernel.

    python -m kpgnn_tpu_torch.scripts.train_counting --backend pallas \\
        --task 0 --ystd full --runs 2
"""
from __future__ import annotations

import time

import numpy as np

from ..data.counting import generate_counting_dataset
from ..train.loop import resolve_device
from .common import (base_parser, cli, fit_runs, model_config, prepare,
                     setup_run)


def parser():
    p = base_parser("substructure counting", model_name="KPGINPlus", K=3,
                    hidden_size=96, num_layer=3, num_epochs=250,
                    batch_size=64, kernel="spd", JK="concat", lr=1e-2,
                    max_pe_num=50, max_hop_num=5, max_edge_type=1,
                    max_edge_count=50, max_distance_count=100, patience=10,
                    runs=4, l2_wd=3e-7)
    p.add_argument("--task", type=int, default=0, choices=range(5))
    # ~5k graphs as upstream's randomgraph.mat; fewer are sample-starved
    p.add_argument("--n_graphs", type=int, default=5000)
    p.add_argument("--ystd", choices=("train", "full"), default="train")
    return p


def datasets(args):
    """The prepped {"train", "val", "test"} splits, y the task's count
    divided by its std."""
    data = generate_counting_dataset(args.n_graphs, seed=1234)
    t = args.task
    if args.ystd == "full":
        ystd = np.std([g["y"][t] for split in data.values()
                       for g in split], ddof=1)
    else:
        ystd = np.std([g["y"][t] for g in data["train"]])
    for split in data.values():
        for g in split:
            g["y"] = np.array([g["y"][t] / ystd], np.float32)
    return {k: prepare(v, args, f"count_{k}_{args.n_graphs}")
            for k, v in data.items()}


def config(args):
    return model_config(args, input_encoder=("embedding", 2),
                        task="graph_regression", output_size=1)


def main(argv=None, epoch_callback=None):
    """Returns the mean best-val test MAE (std-normalized) over runs.
    ``epoch_callback`` (epoch, model, row), if given, sees every epoch's
    history row."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    save_dir, logger = setup_run(args, f"count{args.task}")
    t0 = time.perf_counter()
    splits = datasets(args)
    logger.info(f"data: {args.n_graphs} graphs generated and prepped in "
                f"{time.perf_counter() - t0:.1f} s")
    maes = []
    for run, best in enumerate(fit_runs(args, splits, config(args), "l1",
                                        logger,
                                        epoch_callback=epoch_callback)):
        maes.append(best.get("loss", float("nan")))
        logger.info(f"run {run}: test MAE {maes[-1]:.5f}")
    logger.info(f"task {args.task} std-normalized MAE: "
                f"{np.mean(maes):.5f} +- {np.std(maes):.5f}")
    return float(np.mean(maes))


if __name__ == "__main__":
    cli(main, parser)
