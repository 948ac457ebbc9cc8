"""Shared CLI plumbing for the training scripts (counterpart of
kpgnn_tpu/scripts/common.py).

The argparse surface is the JAX package's, flag for flag, plus
``--device`` (default ``cuda``).  ``--backend`` takes ``coo`` (the
flag's default, as in the JAX CLI: plain PyTorch ``index_add_``
aggregation, as the JAX COO backend is plain XLA) or ``pallas`` (the
hand-written CUDA gather/segment-sum).  Options whose code paths are not
ported yet raise ``NotImplementedError`` naming ROADMAP.md instead of
being ignored: ``--backend dense|banded``, ``--dense``, ``--bf16``,
``--parallel``, ``--resident on``, ``--load_path``, ``--save_checkpoints``,
``--profile_dir``.  The prep cache (``--cache_dir``, ``--reprocess``) and
the prep worker pool (``--num_workers``) are not ported: prep runs
serially, uncached.  ``--matmul_precision`` has nothing to select: the
port always runs matmuls in full f32.
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import torch

from ..models.factory import ModelConfig
from ..prep.khop import KHopConfig, apply_ablation_clamps, extract_graphs
from ..train.config import TrainConfig
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
                   help="profiler trace of epoch 1 (not ported yet)")
    p.add_argument("--dense", action="store_true",
                   help="shorthand for --backend dense (not ported yet)")
    p.add_argument("--backend", type=str, default="coo",
                   choices=("coo", "dense", "pallas", "banded"),
                   help="adjacency backend: 'coo' (index_add_ segment "
                        "sums) or 'pallas' (the fused-hop CUDA "
                        "gather/segment-sum plan); 'dense' and 'banded' "
                        "are not ported yet")
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 activations (not ported yet)")
    p.add_argument("--matmul_precision", type=str,
                   default=d.get("matmul_precision", "default"),
                   choices=("default", "high", "highest"),
                   help="accepted for flag parity; the port always runs "
                        "matmuls in full f32")
    p.add_argument("--resident", type=str, default="auto",
                   choices=("auto", "on", "off"),
                   help="device-resident epochs (not ported yet: 'on' "
                        "raises, 'auto' and 'off' train per batch)")
    p.add_argument("--parallel", nargs="?", const="data", default=None,
                   choices=("data", "node"),
                   help="multi-device training (not ported yet)")
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


def check_ported(args) -> None:
    """Raise for options whose code paths are not ported yet."""
    unported = []
    backend = "dense" if args.dense else args.backend
    if backend not in ("coo", "pallas"):
        unported.append(f"--backend {backend} (coo and pallas are ported)")
    if args.bf16:
        unported.append("--bf16")
    if args.parallel:
        unported.append("--parallel")
    if args.resident == "on":
        unported.append("--resident on")
    if args.load_path or args.save_checkpoints:
        unported.append("checkpoints")
    if args.profile_dir:
        unported.append("--profile_dir")
    if unported:
        raise NotImplementedError(
            "not ported to kpgnn_tpu_torch yet (ROADMAP.md, Queue 1): "
            + ", ".join(unported))


def set_full_f32() -> None:
    """Full-f32 matmuls and convolutions on the card: TF32 off for both
    cuBLAS and cuDNN (cuDNN's default would round to TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def setup_run(args, dataset: str):
    check_ported(args)
    set_full_f32()
    name = run_name(args, dataset)
    save_dir = get_save_dir(args.save_dir, name)
    args.save_dir = save_dir
    logger = get_logger(save_dir, name)
    logger.info(json.dumps(vars(args), indent=2, default=str))
    return save_dir, logger


def prepare(raw_graphs, args):
    """k-hop preprocessing plus the runtime ablation clamps."""
    graphs = extract_graphs(raw_graphs, khop_config(args))
    if args.wo_path_encoding or args.wo_edge_feature:
        graphs = [apply_ablation_clamps(g, args.wo_path_encoding,
                                        args.wo_edge_feature)
                  for g in graphs]
    return graphs


def loader_kwargs(args, mcfg: ModelConfig) -> dict:
    """Loader kwargs of the chosen backend; the kernel plan needs the
    model's vocab sizes and refuses ``--aggr max``, as in the JAX CLI."""
    if args.backend == "coo":
        return {"mode": "coo"}
    if args.aggr == "max":
        raise SystemExit("--aggr max is not available on the pallas "
                         "backend (the kernel is sum-only) — use "
                         "--backend coo")
    return {"mode": "pallas", "v1": mcfg.num_hop1_edge + 2,
            "vk": mcfg.max_pe_num + 2}
