"""Shared CLI plumbing for the training scripts (counterpart of
kpgnn_tpu/scripts/common.py).

The argparse surface is the JAX package's, flag for flag, plus
``--device`` (default ``cuda``).  ``--backend`` takes ``coo`` (the
flag's default, as in the JAX CLI: a gather and sorted segment sums,
``ops/segment.py``, which on the card run the gather kernel with
identity senders), ``pallas`` (the
hand-written CUDA gather/segment-sum), ``dense`` (per-graph hop tiles,
batched matmuls on cuBLAS; ``--dense`` is its shorthand) or ``banded``
(halo-window masks for large, locally ordered graphs, one batched
matmul and a COO spill; KPGCN gets the plan with its sender scale folded
in).  ``--bf16`` runs the activations in bf16 (parameters, norm
statistics and losses stay f32; the kernel takes its bf16 variants).
``--resident`` (auto|on|off) keeps dense, COO and banded datasets on the
device (``train.loop.resident_rule``).  ``prepare`` caches prep under
``--cache_dir`` (default ``<dataset_dir>/cache``, or
``KPGNN_CACHE_DIR``), ``--reprocess`` rebuilds it and ``--num_workers``
> 1 preps on a pool of processes.  ``--load_path`` warm-starts from a
checkpoint, ``--save_checkpoints`` keeps the best epochs' under
``<save_dir>/checkpoints`` and ``--profile_dir`` gets a torch.profiler
trace of epoch 1 (train/loop.Trainer).  ``--parallel data|node`` trains
over a process group (parallel/): under torchrun's environment the run
joins that group (NCCL on the card, gloo on the CPU); run as a command
on a machine with more than one visible GPU, ``cli`` starts one process
per GPU; otherwise the run is a group of one, in this process.
``--matmul_precision`` has nothing to select: the port runs f32 matmuls
in full f32.
"""
from __future__ import annotations

import argparse
import importlib
import json
import logging
import os
import sys
from typing import List, Optional

import torch
import torch.distributed as dist

from ..models.factory import ModelConfig, make_model
from ..parallel import mesh as mesh_lib
from ..prep.khop import KHopConfig, apply_ablation_clamps
from ..prep.runner import preprocess_graphs
from ..train.config import TrainConfig
from ..train.loader import GraphLoader
from ..train.loop import Trainer
from ..utils.logging import get_logger, get_save_dir


def base_parser(description: str, **defaults) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=description)
    d = {
        "save_dir": "./save", "seed": 234, "drop_prob": 0.0,
        "batch_size": 32, "lr": 1e-3, "min_lr": 1e-6, "l2_wd": 0.0,
        "num_epochs": 100, "kernel": "spd", "hidden_size": 48,
        "model_name": "KPGIN", "K": 3, "max_pe_num": 30, "max_edge_type": 1,
        "max_edge_count": 10, "max_hop_num": 3, "max_distance_count": 10,
        "num_hop1_edge": 1, "num_layer": 2, "JK": "last", "combine":
        "geometric", "pooling_method": "sum", "norm_type": "Batch",
        "aggr": "add", "factor": 0.5, "patience": 10, "runs": 1,
        "num_l1_layer": 1, "eps": 0.0, "num_workers": 0,
    }
    d.update(defaults)
    p.add_argument("--save_dir", type=str, default=d["save_dir"])
    p.add_argument("--dataset_dir", type=str, default="./data")
    # prep cache location; defaults to <dataset_dir>/cache. Point this
    # elsewhere when dataset_dir is a read-only mount (env
    # KPGNN_CACHE_DIR works too, flag wins).
    p.add_argument("--cache_dir", type=str,
                   default=os.environ.get("KPGNN_CACHE_DIR"))
    p.add_argument("--seed", type=int, default=d["seed"])
    p.add_argument("--drop_prob", type=float, default=d["drop_prob"])
    p.add_argument("--batch_size", type=int, default=d["batch_size"])
    p.add_argument("--num_workers", type=int, default=d["num_workers"])
    p.add_argument("--lr", type=float, default=d["lr"])
    p.add_argument("--min_lr", type=float, default=d["min_lr"])
    p.add_argument("--l2_wd", type=float, default=d["l2_wd"])
    p.add_argument("--num_epochs", type=int, default=d["num_epochs"])
    p.add_argument("--kernel", type=str, default=d["kernel"],
                   choices=("gd", "spd"))
    p.add_argument("--hidden_size", type=int, default=d["hidden_size"])
    p.add_argument("--model_name", type=str, default=d["model_name"],
                   choices=("KPGCN", "KPGIN", "KPGraphSAGE", "KPGINPlus",
                            "KPGINPrime"))
    p.add_argument("--K", type=int, default=d["K"])
    p.add_argument("--max_pe_num", type=int, default=d["max_pe_num"])
    p.add_argument("--max_edge_type", type=int, default=d["max_edge_type"])
    p.add_argument("--max_edge_count", type=int, default=d["max_edge_count"])
    p.add_argument("--max_hop_num", type=int, default=d["max_hop_num"])
    p.add_argument("--max_distance_count", type=int,
                   default=d["max_distance_count"])
    p.add_argument("--num_hop1_edge", type=int, default=d["num_hop1_edge"])
    p.add_argument("--num_layer", type=int, default=d["num_layer"])
    p.add_argument("--num_l1_layer", type=int, default=d["num_l1_layer"])
    p.add_argument("--JK", type=str, default=d["JK"],
                   choices=("last", "concat", "max", "sum", "attention"))
    p.add_argument("--combine", type=str, default=d["combine"],
                   choices=("attention", "geometric"))
    p.add_argument("--pooling_method", type=str, default=d["pooling_method"],
                   choices=("mean", "sum", "max", "attention"))
    p.add_argument("--norm_type", type=str, default=d["norm_type"],
                   choices=("Batch", "Layer", "Instance", "GraphSize", "Pair"))
    p.add_argument("--aggr", type=str, default=d["aggr"])
    p.add_argument("--factor", type=float, default=d["factor"])
    p.add_argument("--patience", type=int, default=d["patience"])
    p.add_argument("--runs", type=int, default=d["runs"])
    p.add_argument("--eps", type=float, default=d["eps"])
    p.add_argument("--virtual_node", action="store_true")
    p.add_argument("--residual", action="store_true")
    p.add_argument("--use_rd", action="store_true")
    p.add_argument("--train_eps", action="store_true")
    p.add_argument("--wo_peripheral_edge", action="store_true")
    p.add_argument("--wo_peripheral_configuration", action="store_true")
    p.add_argument("--wo_path_encoding", action="store_true")
    p.add_argument("--wo_edge_feature", action="store_true")
    p.add_argument("--reprocess", action="store_true")
    p.add_argument("--load_path", type=str, default=None,
                   help="checkpoint to warm-start from (reference "
                        "declares this flag but leaves it dead)")
    p.add_argument("--save_checkpoints", action="store_true",
                   help="write best-val checkpoints under "
                        "save_dir/checkpoints")
    p.add_argument("--profile_dir", type=str, default=None,
                   help="torch.profiler chrome trace of epoch 1 (epoch 0 "
                        "when there is one), read by "
                        "kpgnn_tpu_torch.utils.trace_summary")
    p.add_argument("--dense", action="store_true",
                   help="shorthand for --backend dense")
    p.add_argument("--backend", type=str, default="coo",
                   choices=("coo", "dense", "pallas", "banded"),
                   help="adjacency backend: 'coo' (sorted segment "
                        "sums), 'pallas' (the fused-hop CUDA "
                        "gather/segment-sum plan), 'dense' (per-graph "
                        "hop tiles, batched matmuls) or 'banded' "
                        "(halo-window masks, one batched matmul, a COO "
                        "spill)")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations; parameters, norm statistics "
                        "and losses stay f32")
    p.add_argument("--matmul_precision", type=str,
                   default=d.get("matmul_precision", "default"),
                   choices=("default", "high", "highest"),
                   help="accepted for flag parity; the port runs f32 "
                        "matmuls in full f32")
    p.add_argument("--resident", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="device-resident epochs for dense, coo and "
                        "banded loaders: 'auto' when the store fits "
                        "KPGNN_RESIDENT_MAX_BYTES (coo: and its slots are "
                        "at least half full)")
    p.add_argument("--parallel", nargs="?", const="data", default=None,
                   choices=("data", "node"),
                   help="training over every visible device: 'data' "
                        "(default when the flag is bare) = one batch per "
                        "rank with gradient sums; 'node' = every batch "
                        "node-sharded over the ranks with a halo exchange "
                        "(for graphs too large for one card)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on; without CUDA the run "
                        "raises unless --device cpu is given")
    return p


def khop_config(args, use_rd: Optional[bool] = None) -> KHopConfig:
    return KHopConfig(
        K=args.K, kernel=args.kernel, max_edge_attr_num=args.max_pe_num,
        max_hop_num=args.max_hop_num, max_edge_type=args.max_edge_type,
        max_edge_count=args.max_edge_count,
        max_distance_count=args.max_distance_count,
        use_rd=args.use_rd if use_rd is None else use_rd,
    )


def model_config(args, input_encoder, task, output_size,
                 num_hop1_edge: Optional[int] = None) -> ModelConfig:
    return ModelConfig(
        model_name=args.model_name, hidden_size=args.hidden_size,
        num_layer=args.num_layer, K=args.K, kernel=args.kernel,
        combine=args.combine, aggr=args.aggr, JK=args.JK,
        norm_type=args.norm_type, virtual_node=args.virtual_node,
        residual=args.residual, use_rd=args.use_rd,
        drop_prob=args.drop_prob, eps=args.eps, train_eps=args.train_eps,
        num_l1_layer=args.num_l1_layer,
        num_hop1_edge=(num_hop1_edge if num_hop1_edge is not None
                       else args.num_hop1_edge),
        max_pe_num=args.max_pe_num, max_edge_type=args.max_edge_type,
        max_edge_count=args.max_edge_count, max_hop_num=args.max_hop_num,
        max_distance_count=args.max_distance_count,
        wo_peripheral_edge=args.wo_peripheral_edge,
        wo_peripheral_configuration=args.wo_peripheral_configuration,
        wo_path_encoding=args.wo_path_encoding,
        wo_edge_feature=args.wo_edge_feature,
        input_encoder=input_encoder, task=task,
        pooling_method=args.pooling_method, output_size=output_size,
        compute_dtype="bfloat16" if getattr(args, "bf16", False)
        else "float32",
    )


def train_config(args, loss: str, stop_at_min_lr: bool = False) -> TrainConfig:
    return TrainConfig(
        lr=args.lr, min_lr=args.min_lr, l2_wd=args.l2_wd,
        num_epochs=args.num_epochs, batch_size=args.batch_size,
        seed=args.seed, runs=args.runs, factor=args.factor,
        patience=args.patience, loss=loss, stop_at_min_lr=stop_at_min_lr,
        save_dir=args.save_dir, load_path=args.load_path,
        save_checkpoints=args.save_checkpoints,
        profile_dir=args.profile_dir,
    )


def run_name(args, dataset: str) -> str:
    return (f"{dataset}_{args.model_name}_{args.kernel}_K{args.K}"
            f"_L{args.num_layer}_h{args.hidden_size}_{args.combine}")


def backend(args) -> str:
    """The adjacency backend: ``--backend``, or dense under ``--dense``."""
    return "dense" if args.dense else args.backend


def set_full_f32() -> None:
    """Full-f32 matmuls and convolutions on the card: TF32 off for both
    cuBLAS and cuDNN (cuDNN's default would round to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def maybe_mesh(args):
    """--parallel [data|node]: a one-axis mesh over the process group,
    named after the mode; None without --parallel.  Joins torchrun's
    group (NCCL for a cuda --device, else gloo), or forms a group of one
    in this process, unless the group exists already (a rank started by
    ``cli``)."""
    mode = getattr(args, "parallel", None)
    if not mode:
        return None
    backend = "nccl" if torch.device(args.device).type == "cuda" else "gloo"
    if not dist.is_initialized():
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            mesh_lib.from_env(backend)
        else:
            mesh_lib.local_group(backend)
    return mesh_lib.make_mesh(("node" if mode == "node" else "data",),
                              device=mesh_lib.default_device(
                                  dist.get_backend()))


def parallel_kwargs(args, mcfg: Optional[ModelConfig] = None) -> dict:
    """Trainer kwargs of the execution mode: ``resident``, and under
    --parallel the mesh and the mode; under --parallel node with
    --backend pallas|banded the local plans attach at partition time
    (the loader collates COO, ``loader_kwargs``), so the Trainer gets
    their vocab sizes here."""
    kw = {"resident": getattr(args, "resident", "auto")}
    mode = getattr(args, "parallel", None)
    if mode:
        kw.update(mesh=maybe_mesh(args), parallel_mode=mode)
        if mode == "node" and backend(args) in ("pallas", "banded"):
            if mcfg is None:
                raise ValueError(
                    "--parallel node with --backend pallas/banded needs "
                    "the model config for plan vocab sizes")
            kw["partition_plans"] = {backend(args): {
                "v1": mcfg.num_hop1_edge + 2, "vk": mcfg.max_pe_num + 2}}
    return kw


def _rank_cli(rank: int, world_size: int, module: str, argv: List[str]):
    importlib.import_module(module).main(argv)


def cli(main, parser) -> None:
    """A script's command-line entry.  --parallel on a cuda --device with
    more than one visible GPU, outside torchrun's environment: one NCCL
    rank per GPU, each running ``main`` on the command line's arguments.
    Otherwise ``main()`` in this process."""
    args, _ = parser().parse_known_args()
    n_gpus = (torch.cuda.device_count()
              if torch.device(args.device).type == "cuda" else 0)
    if args.parallel and n_gpus > 1 and "RANK" not in os.environ:
        module = main.__module__
        if module == "__main__":
            module = sys.modules["__main__"].__spec__.name
        mesh_lib.spawn(_rank_cli, n_gpus, "nccl",
                       args=(module, sys.argv[1:]))
    else:
        main()


def setup_run(args, dataset: str):
    """The run's save directory and logger.  Under --parallel only rank 0
    logs and makes the numbered run directory; another rank gets a
    logger that drops messages and ``<save_dir>/train/rank<r>``."""
    set_full_f32()
    name = run_name(args, dataset)
    mesh = maybe_mesh(args)
    if mesh is not None and mesh.rank != 0:
        save_dir = os.path.join(args.save_dir, "train", f"rank{mesh.rank}")
        os.makedirs(save_dir, exist_ok=True)
        args.save_dir = save_dir
        logger = logging.getLogger(f"{name}.rank{mesh.rank}")
        logger.handlers[:] = [logging.NullHandler()]
        logger.propagate = False
        return save_dir, logger
    save_dir = get_save_dir(args.save_dir, name)
    args.save_dir = save_dir
    logger = get_logger(save_dir, name)
    logger.info(json.dumps(vars(args), indent=2, default=str))
    return save_dir, logger


def prepare(raw_graphs, args, cache_name: str):
    """k-hop preprocessing, cached under ``cache_name`` in ``--cache_dir``
    (default ``<dataset_dir>/cache``), plus the runtime ablation
    clamps."""
    graphs = preprocess_graphs(
        raw_graphs, khop_config(args),
        cache_dir=args.cache_dir or os.path.join(args.dataset_dir, "cache"),
        name=cache_name, num_workers=args.num_workers,
        reprocess=args.reprocess)
    if args.wo_path_encoding or args.wo_edge_feature:
        graphs = [apply_ablation_clamps(g, args.wo_path_encoding,
                                        args.wo_edge_feature)
                  for g in graphs]
    return graphs


def loader_kwargs(args, mcfg: ModelConfig) -> dict:
    """Loader kwargs of the chosen backend; the kernel plan, the dense
    tiles and the banded plan need the model's vocab sizes, KPGCN's
    banded plan folds in its sender scale, and the kernel and banded
    plans refuse ``--aggr max``, as in the JAX CLI.  Under --parallel
    node the kernel and banded plans attach at partition time
    (``parallel_kwargs``), so the loader collates COO."""
    mode = backend(args)
    aggr = getattr(args, "aggr", "add")
    if aggr == "max" and mode in ("pallas", "banded"):
        raise SystemExit(
            f"--aggr max is not available on the {mode} backend (its "
            "plan stores attr histograms / one-hot sums, not the per-edge "
            "codes max needs) — use --backend coo or dense")
    if mode == "coo" or (getattr(args, "parallel", None) == "node"
                         and mode in ("pallas", "banded")):
        return {"mode": "coo"}
    kw = {"mode": mode, "v1": mcfg.num_hop1_edge + 2,
          "vk": mcfg.max_pe_num + 2}
    if mode == "banded" and mcfg.model_name == "KPGCN":
        kw["banded_gcn_norm"] = True
    return kw


def fit_runs(args, splits, mcfg: ModelConfig, loss: str, logger,
             node_level: bool = False, epoch_callback=None) -> List[dict]:
    """``args.runs`` runs of the plateau-scheduled trainer (gated on the
    validation loss, stopping at min_lr) on the prepped ``splits``
    ({"train", "val", "test"}); run r shuffles and initializes from
    ``args.seed + r``.  Returns each run's best-val test metrics."""
    lk = loader_kwargs(args, mcfg)
    results = []
    for run in range(args.runs):
        tl = GraphLoader(splits["train"], args.batch_size, shuffle=True,
                         seed=args.seed + run, y_is_node_level=node_level,
                         **lk)
        vl, el = (GraphLoader(splits[k], args.batch_size,
                              y_is_node_level=node_level, **lk)
                  for k in ("val", "test"))
        trainer = Trainer(make_model(mcfg),
                          train_config(args, loss, stop_at_min_lr=True),
                          loss=loss, node_level=node_level, logger=logger,
                          device=args.device,
                          **parallel_kwargs(args, mcfg))
        _, res = trainer.fit(tl, vl, el, seed=args.seed + run,
                             epoch_callback=epoch_callback)
        results.append(res["best_test"])
    return results
