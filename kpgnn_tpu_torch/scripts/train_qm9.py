"""QM9 per-target regression (counterpart of kpgnn_tpu/scripts/train_qm9.py).

One of 19 targets; MSE train loss on standardized targets, evaluation MAE
x std; a 10/10/80 val/test/train split after a seeded shuffle.  Canonical
config: KPGINPlus K=8 L=8 h=128, attention combine and pooling,
--virtual_node --use_rd.  The port trains on ``--device`` (default cuda;
without CUDA it raises unless ``--device cpu`` is given) and on
``--backend coo`` (the default), ``pallas`` (the CUDA gather kernel) or
``dense`` (per-graph hop tiles, batched matmuls).

    python -m kpgnn_tpu_torch.scripts.train_qm9 --backend pallas \\
        --virtual_node --use_rd --dataset_dir <dir holding QM9/raw/>
"""
from __future__ import annotations

import os

import numpy as np

from ..data.molecules import QM9_CONVERSION, load_qm9, load_qm9_raw
from ..models.factory import make_model
from ..train.loader import GraphLoader
from ..train.loop import Trainer, resolve_device
from .common import (base_parser, cli, loader_kwargs, model_config,
                     parallel_kwargs, prepare, setup_run, train_config)


def parser():
    p = base_parser("QM9 regression", model_name="KPGINPlus", K=8,
                    hidden_size=128, num_layer=8, num_epochs=200,
                    batch_size=128, JK="last", combine="attention",
                    pooling_method="attention", num_hop1_edge=4,
                    max_pe_num=50, max_edge_type=4, max_edge_count=20,
                    max_hop_num=5, max_distance_count=15, lr=1e-3,
                    patience=5)
    p.add_argument("--task", type=int, default=0, choices=range(19))
    p.add_argument("--use_pos", action="store_true")
    # "post": train in converted (eV) units and log the MAE converted back;
    # "pre": divide the targets back to their original units first
    p.add_argument("--convert", type=str, default="post",
                   choices=("pre", "post"))
    # qm9_v3.pt ships y already reordered and converted (the default);
    # set this only for a dump still in raw gdb9 CSV order and units
    p.add_argument("--qm9_raw_targets", action="store_true")
    return p


def load(args):
    """Raw graph dicts: qm9_v3.pt, or the raw gdb9 artifacts when only
    those are present."""
    root = os.path.join(args.dataset_dir, "QM9")
    raw = os.path.join(root, "raw")
    if (not os.path.exists(os.path.join(raw, "qm9_v3.pt"))
            and os.path.exists(os.path.join(raw, "gdb9.sdf"))):
        return load_qm9_raw(root)
    return load_qm9(root, targets_raw_order=args.qm9_raw_targets)


def split(n: int, seed: int):
    """(train, val, test) indices: a seeded permutation, 10% val, 10%
    test, the rest train."""
    order = np.random.default_rng(seed).permutation(n)
    n_val = n_test = n // 10
    return (order[n_val + n_test:], order[:n_val],
            order[n_val:n_val + n_test])


def task_splits(graphs, args):
    """The (train, val, test) graph lists of ``split`` with y the task's
    target (divided by its unit conversion under ``--convert pre``),
    standardized by the train set's float64 mean and std; and the std."""
    t = args.task
    y = np.array([float(np.asarray(g.y).reshape(-1)[t]) for g in graphs])
    if args.convert == "pre":
        y = np.array([float(np.float32(v) / np.float32(QM9_CONVERSION[t]))
                      for v in y])
    idx = split(len(graphs), args.seed)
    mean, std = y[idx[0]].mean(), y[idx[0]].std()
    return tuple([graphs[i].replace(
        y=np.array([(y[i] - mean) / std], np.float32)) for i in ids]
        for ids in idx), std


def main(argv=None, epoch_callback=None):
    """Returns the best-val epoch's test MAE in dataset units.
    ``epoch_callback`` (epoch, model, row), if given, sees every epoch's
    history row."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    save_dir, logger = setup_run(args, f"QM9t{args.task}")
    (train, val, test), std = task_splits(
        prepare(load(args), args, "QM9"), args)

    mcfg = model_config(args, input_encoder=("qm9", int(args.use_pos)),
                        task="graph_regression", output_size=1)
    lk = loader_kwargs(args, mcfg)
    tl = GraphLoader(train, args.batch_size, shuffle=True, seed=args.seed,
                     **lk)
    vl = GraphLoader(val, args.batch_size, **lk)
    el = GraphLoader(test, args.batch_size, **lk)
    trainer = Trainer(make_model(mcfg),
                      train_config(args, "mse", stop_at_min_lr=True),
                      loss="mse", metric_mode="min", eval_metric="mae",
                      logger=logger, device=args.device,
                      **parallel_kwargs(args, mcfg))
    _, res = trainer.fit(tl, vl, el, seed=args.seed,
                         epoch_callback=epoch_callback)
    # MAE in dataset units, normalized, and converted back to the
    # original units when training post-conversion
    t = args.task
    mae = res["best_test"].get("mae", float("nan")) * std
    mae_norm = mae / std
    mae_convert = (mae / float(QM9_CONVERSION[t])
                   if args.convert == "post" else 0.0)
    logger.info(f"QM9 target {t}: test MAE {mae:.5f}, "
                f"MAE norm {mae_norm:.5f}, MAE convert {mae_convert:.5f}")
    return float(mae)


if __name__ == "__main__":
    cli(main, parser)
