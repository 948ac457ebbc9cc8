"""TU graph-kernel benchmarks (counterpart of kpgnn_tpu/scripts/train_tu.py).

Two protocols:
  * GIN split (MUTAG/PTC/PROTEINS/IMDB-B, or any dataset with a GIN-format
    <name>.txt): the 10-fold index files, ``--folds`` of them;
  * stratified k-fold (standard-format TU datasets such as DD), train and
    val merged.
Each fold trains with the LR times ``--factor`` every 50 epochs, and
records the test accuracy at every epoch; the run reports the mean of
each fold's best, the best of the epoch-mean curve, and the final
epoch's.  The hidden size is rounded up to a multiple of K.

As in the JAX script, ``--dense`` folds train device-resident unless
``--resident off`` (train/resident.py: the fold's train and test sets
live on the device, each step gathers its batch there); other backends
train per batch.  ``--device`` defaults to
cuda (without CUDA it raises unless ``--device cpu`` is given);
``--backend pallas`` runs the aggregation through the CUDA kernel.  The
TU files are not in the repository; ``--dataset_dir`` points at a tree
holding <name>/<name>.txt (or the standard files).

    python -m kpgnn_tpu_torch.scripts.train_tu --backend pallas \\
        --dataset_name MUTAG --dataset_dir <dir>
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..data.tu import load_tu_gin_split, load_tu_standard, num_tag_classes
from ..models.factory import make_model
from ..nn.inits import init_parameters
from ..train.kfold import k_fold
from ..train.loader import GraphLoader
from ..train.loop import evaluate, resolve_device, train_epoch
from ..train.lr import StepDecay
from ..train.resident import (build_dense_store, epoch_index_chunks,
                              make_resident_eval, make_resident_train_epoch)
from ..train.state import get_lr, make_optimizer, set_lr
from .common import (backend, base_parser, loader_kwargs, model_config,
                     prepare, setup_run)

GIN_SPLIT_SETS = ("MUTAG", "PTC", "PROTEINS", "IMDBBINARY", "IMDBMULTI",
                  "NCI1", "COLLAB", "REDDITBINARY", "REDDITMULTI5K")


def parser():
    p = base_parser("TU classification", model_name="KPGIN", K=2,
                    hidden_size=32, num_layer=3, num_epochs=350,
                    batch_size=32, lr=1e-2, max_pe_num=30, max_hop_num=3,
                    max_edge_type=1, max_edge_count=10,
                    max_distance_count=10, drop_prob=0.5, l2_wd=3e-4)
    p.add_argument("--dataset_name", type=str, default="MUTAG")
    p.add_argument("--folds", type=int, default=10)
    return p


def one_hot_x(graphs, n_classes):
    for g in graphs:
        oh = np.zeros((g["num_nodes"], n_classes), dtype=np.float32)
        oh[np.arange(g["num_nodes"]), g["x"][:, 0]] = 1.0
        g["x"] = oh
    return graphs


def load(args):
    """(prepped graphs with one-hot tags, [(train idx, test idx)] of the
    folds to run, number of tags, number of classes)."""
    name = args.dataset_name
    gin_txt = os.path.join(args.dataset_dir, name, f"{name}.txt")
    if (os.path.exists(gin_txt)
            or name.upper().replace("_", "") in GIN_SPLIT_SETS):
        raw, folds = load_tu_gin_split(args.dataset_dir, name)
    else:
        raw, folds = load_tu_standard(args.dataset_dir, name), []
    n_tag = num_tag_classes(raw)
    n_classes = int(max(int(g["y"][0]) for g in raw)) + 1
    graphs = prepare(one_hot_x(raw, n_tag), args, name)
    if folds:
        folds = folds[:args.folds]
    else:                   # the reference merges train and val
        folds = [(np.concatenate([tr, va]), te) for tr, va, te in k_fold(
            len(graphs), [int(g.y[0]) for g in graphs], folds=args.folds,
            seed=args.seed)]
    return graphs, folds, n_tag, n_classes


def config(args, n_tag, n_classes):
    """The model config; the hidden size rounded up to a multiple of K
    (hidden 33 when K=3, reference: train_TU.py:395-398)."""
    if args.hidden_size % args.K:
        args.hidden_size += args.K - args.hidden_size % args.K
    return model_config(args, input_encoder=("linear", n_tag),
                        task="graph_classification", output_size=n_classes)


def run_fold(mcfg, args, logger, fold, train_graphs, test_graphs, lk,
             epoch_callback=None):
    """One fold: step decay by ``--factor`` every 50 epochs and the test
    accuracy of every epoch, resident under ``--dense`` unless
    ``--resident off`` (the JAX script's rule), else per batch.  The
    model and the shuffle start from seed ``--seed`` + fold (the
    resident order is the per-batch loader's).  Returns the accuracies,
    (epochs,)."""
    device = resolve_device(args.device)
    seed = args.seed + fold
    B = args.batch_size
    model = init_parameters(make_model(mcfg), seed).to(device)
    opt = make_optimizer(model.parameters(), args.lr, args.l2_wd)
    generator = torch.Generator(device=device).manual_seed(seed)
    if lk["mode"] == "dense" and args.resident != "off":
        stores = [build_dense_store(gs, lk["n_slot"], lk["v1"], lk["vk"],
                                    device=device)
                  for gs in (train_graphs, test_graphs)]
        test_chunks = epoch_index_chunks(np.arange(len(test_graphs)), B,
                                         stores[1].num_graphs)
        perm = np.random.default_rng(seed)
        train_ep = make_resident_train_epoch(model, opt, "cross_entropy")
        test_ep = make_resident_eval(model, "cross_entropy")
        logger.info(f"fold {fold}: resident stores on {device}, "
                    f"{stores[0].nbytes() + stores[1].nbytes()} B")

        def train_one():
            return train_ep(stores[0], epoch_index_chunks(
                perm.permutation(len(train_graphs)), B,
                stores[0].num_graphs), generator)

        def test_one():
            return test_ep(stores[1], test_chunks)
    else:
        tl = GraphLoader(train_graphs, B, shuffle=True, seed=seed, **lk)
        test = [b.to(device) for b in GraphLoader(test_graphs, B, **lk)]

        def train_one():
            return train_epoch(model, opt, (b.to(device) for b in tl),
                               "cross_entropy", generator)

        def test_one():
            return evaluate(model, test, "cross_entropy")
    decay = StepDecay(every=50, factor=args.factor)
    accs = []
    for epoch in range(args.num_epochs):
        t0 = time.time()
        set_lr(opt, decay.lr_at(args.lr, epoch))
        loss, step_losses = train_one()
        accs.append(test_one()["accuracy"])
        row = {"epoch": epoch, "train_loss": loss, "lr": get_lr(opt),
               "seconds": time.time() - t0, "step_losses": step_losses,
               "test_accuracy": accs[-1]}
        if epoch_callback is not None:
            epoch_callback(epoch, model, row)
        if (epoch + 1) % 25 == 0:
            logger.info(f"fold {fold} epoch {epoch}: lr {row['lr']:.6f} "
                        f"loss {loss:.4f} test acc {accs[-1]:.4f}")
    return np.array(accs)


def main(argv=None, epoch_callback=None):
    """Returns the best epoch-mean test accuracy over the folds.
    ``epoch_callback`` (epoch, model, row), if given, sees every epoch's
    row."""
    args = parser().parse_args(argv)
    resolve_device(args.device)
    save_dir, logger = setup_run(args, args.dataset_name)
    graphs, folds, n_tag, n_classes = load(args)
    mcfg = config(args, n_tag, n_classes)
    lk = loader_kwargs(args, mcfg)
    if backend(args) == "dense":
        # one dataset-wide slot size for every fold
        lk["n_slot"] = -(-max(g.num_nodes for g in graphs) // 8) * 8

    acc = np.stack([run_fold(mcfg, args, logger, fold,
                             [graphs[i] for i in tr],
                             [graphs[i] for i in te], lk, epoch_callback)
                    for fold, (tr, te) in enumerate(folds)])
    per_fold_max = acc.max(axis=1)            # acc is (folds, epochs)
    epoch_mean = acc.mean(axis=0)
    best_epoch = int(epoch_mean.argmax())
    logger.info(
        f"{args.dataset_name}: fold-max {per_fold_max.mean():.4f} +- "
        f"{per_fold_max.std():.4f}; cross-epoch-max {epoch_mean.max():.4f} "
        f"+- {acc[:, best_epoch].std():.4f}; final-epoch "
        f"{acc[:, -1].mean():.4f} +- {acc[:, -1].std():.4f}")
    return float(epoch_mean.max())


if __name__ == "__main__":
    main()
