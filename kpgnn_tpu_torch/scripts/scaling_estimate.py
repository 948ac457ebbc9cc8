"""Scaling evidence for multi-device training (counterpart of
kpgnn_tpu/scripts/scaling_estimate.py).  Two measurements:

* --mode weak: the parallelization overhead of the port's multi-rank
  steps.  For each P of --ranks, P ranks are spawned over a process group
  (``parallel.mesh.spawn``) and time ``parallel.dp.parallel_train_step``
  (each rank its own 8-graph batch) and
  ``parallel.partition.sharded_train_step`` (the P-rank node partition of
  the whole batch), each against the one-device ``train.loop.train_step``
  on the same total batch in this process: overhead_factor = t_parallel
  / t_single.  The model, data and pads are the JAX script's (KPGINPlus
  K=4 L=4 H=64, geometric combine, residual; 8 synthetic molecules of
  24-32 nodes a rank; n_pad 256·P, e_pad 8192·P; COO aggregation).
  Every row names its process-group backend and device: NCCL with one
  rank a card where the machine has P cards; otherwise gloo, all P ranks
  on the one device (a card or the CPU).  P gloo ranks on one card share
  its queue and stage every collective through the host, so their factor
  measures that staging, not NCCL over NVLink.

* --mode ici, kept under the JAX name for the CLI: the link projection
  for the node-sharded large-graph path.  ``synthetic_polymers(1,
  --n_nodes, K=3)`` is partitioned into --shards shards
  (``parallel.partition.partition_adj``); the halo plan's exact per-layer
  communication (bytes a device sends per aggregation, at D = the hidden
  width 104 in f32) is divided by a link bandwidth and set against the
  measured per-layer forward + backward of ``ops.spmm.khop_spmm`` (the
  kernel) and of ``ops.banded.banded_khop_aggregate`` on a 1/P-size
  polymer on one device: efficiency = t / (t + bytes / bw), a no-overlap
  lower bound.  The bandwidths are assumptions about an H100 machine's
  links, not measurements (``LINK_GBPS``).  The JAX script rounds D up to
  128 lanes, a TPU layout; the port moves D columns.  The output keeps
  the JAX script's keys (``ici_projection``, ``efficiency_vs_ici_GBps``,
  ``banded_efficiency_vs_ici_GBps``): on the card they hold the link
  projection, keyed by the assumed link GB/s.

    python -m kpgnn_tpu_torch.scripts.scaling_estimate --mode both
    python -m kpgnn_tpu_torch.scripts.scaling_estimate --mode ici \\
        --n_nodes 8192 --device cpu

``--device`` defaults to cuda (without CUDA it raises unless ``--device
cpu`` is given).  Prints the results as one JSON object and returns it.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..data.synthetic import synthetic_molecules, synthetic_polymers
from ..graph.batch import collate, collate_banded, collate_pallas
from ..models.factory import ModelConfig, make_model
from ..nn.inits import init_parameters
from ..ops.banded import banded_khop_aggregate
from ..ops.spmm import khop_spmm
from ..parallel.dp import parallel_train_step
from ..parallel.mesh import make_mesh, spawn
from ..parallel.partition import partition_adj, partition_batch, \
    sharded_train_step
from ..prep.khop import KHopConfig
from ..train.loop import resolve_device, train_step
from ..train.state import make_optimizer
from .common import set_full_f32

SEED = 0
# the weak mode's model and data (the JAX script's); ``iters`` steps a
# timed round, best of 3 rounds
WEAK = dict(K=4, num_layer=4, hidden_size=64, per_dev=8, iters=10)
# link bandwidths of an H100 machine, GB/s one way: assumptions, not
# measurements
LINK_GBPS = {
    "25": "PCIe Gen5 x16 per direction, assumed effective",
    "64": "PCIe Gen5 x16 per direction, nominal",
    "200": "NVLink 4 per direction, assumed effective",
    "450": "NVLink 4 per direction, nominal (H100 SXM data sheet)",
}
V1, VK = 5, 32
SPAWN_TIMEOUT = 1800            # seconds a spawned group may take


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step, device, iters) -> float:
    """Seconds per call of ``step``: one warm-up call, then the best of 3
    rounds of ``iters`` calls that end in a synchronize."""
    step()
    _sync(device)
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        _sync(device)
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def _weak_model(cfg: dict, device) -> tuple:
    mcfg = ModelConfig(
        model_name="KPGINPlus", hidden_size=cfg["hidden_size"],
        num_layer=cfg["num_layer"], K=cfg["K"], num_hop1_edge=3,
        max_pe_num=10, max_edge_type=2, max_edge_count=10, max_hop_num=3,
        max_distance_count=10, JK="concat", combine="geometric",
        residual=True, input_encoder=("embedding", 21),
        task="graph_regression", pooling_method="sum")
    model = init_parameters(make_model(mcfg), SEED).to(device)
    return model, make_optimizer(model.parameters(), 1e-3)


def _big_batch(graphs, cfg, P):
    per = cfg["per_dev"]
    return collate(graphs[:per * P], n_pad=256 * P, e_pad=8192 * P,
                   g_pad=per * P + 1)


def _weak_rank(rank, world, graphs, cfg, devices):
    """One rank of a P-rank group: its data-parallel and its node-sharded
    step time (seconds), on ``devices[rank]``."""
    device = torch.device(devices[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    set_full_f32()
    per = cfg["per_dev"]
    out = {}
    mesh = make_mesh(("data",), device=device)
    model, opt = _weak_model(cfg, device)
    batch = collate(graphs[per * rank:per * (rank + 1)], n_pad=256,
                    e_pad=8192, g_pad=per + 1).to(device)
    out["data_parallel"] = _timed(lambda: parallel_train_step(
        model, opt, batch, "l1", mesh=mesh), device, cfg["iters"])
    mesh = make_mesh(("node",), device=device)
    model, opt = _weak_model(cfg, device)
    shard = partition_batch(_big_batch(graphs, cfg, world), world, rank,
                            mesh.group("node")).to(device)
    out["node_sharded"] = _timed(lambda: sharded_train_step(
        model, opt, shard, "l1", mesh=mesh), device, cfg["iters"])
    return out


def _device_name(device: torch.device) -> str:
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def _weak(out, ranks, device):
    cfg = dict(WEAK)
    kcfg = KHopConfig(K=cfg["K"], kernel="spd", max_edge_attr_num=10,
                      max_hop_num=3, max_edge_type=2, max_edge_count=10,
                      max_distance_count=10)
    graphs = synthetic_molecules(cfg["per_dev"] * max(ranks), kcfg, seed=1,
                                 n_min=24, n_max=32)
    rows = {"data_parallel": {}, "node_sharded": {}}
    for P in ranks:
        # the single-device reference: the same total batch through the
        # ordinary train step, in this process
        big = _big_batch(graphs, cfg, P).to(device)
        model, opt = _weak_model(cfg, device)
        t_one = _timed(lambda: train_step(model, opt, big, "l1"), device,
                       cfg["iters"])
        cards = device.type == "cuda" and torch.cuda.device_count() >= P
        backend = "nccl" if cards else "gloo"
        devices = ([torch.device("cuda", r) for r in range(P)] if cards
                   else [device] * P)
        res = spawn(_weak_rank, P, backend,
                    args=(graphs[:cfg["per_dev"] * P], cfg,
                          [str(d) for d in devices]),
                    devices=devices, timeout=SPAWN_TIMEOUT)
        for mode in rows:
            t_par = max(r[mode] for r in res)
            rows[mode][str(P)] = {
                "parallel_step_ms": round(t_par * 1e3, 2),
                "single_device_same_batch_ms": round(t_one * 1e3, 2),
                "overhead_factor": round(t_par / t_one, 3),
                "backend": backend,
                "device": _device_name(device),
                "ranks_per_device": 1 if cards else P,
            }
    out.update(rows)
    out["weak_setup"] = (
        f"KPGINPlus K={cfg['K']} L={cfg['num_layer']} "
        f"H={cfg['hidden_size']}, geometric combine, residual, COO "
        f"aggregation, {cfg['per_dev']} molecules a rank, Adam, L1; "
        "single device = the same total batch in one process; gloo ranks "
        "sharing one device stage every collective through the host (not "
        "an NCCL time)")


def _ici(out, n_nodes, shards, device, kk=3, hidden=104):
    graphs = synthetic_polymers(1, n_nodes, K=kk, seed=0)
    coo = collate(graphs)
    sharded = partition_adj(coo.adj, shards, 0)
    comm_bytes = sharded.comm_elems_per_layer(kk, hidden) * 4
    psum_bytes = sharded.psum_elems_per_layer(kk, hidden) * 4
    edges = int(coo.adj.edge_mask.sum())

    # measured per-layer aggregation (forward + backward) on 1/P of the
    # graph: the per-device compute share under the partition
    local = synthetic_polymers(1, n_nodes // shards, K=kk, seed=0)
    b = collate_pallas(local, v1=V1, vk=VK)
    plan = b.adj.to(device)
    n = b.x.shape[0]
    rng = np.random.default_rng(0)
    x, t1, tk = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(device) for s in ((n, kk, hidden), (V1, hidden),
                                       (VK, hidden)))

    def fwd_bwd(aggregate, adj):
        def step():
            xg = x.detach().requires_grad_(True)
            aggregate(xg, t1, tk, adj).sum().backward()
            return xg.grad
        return _timed(step, device, 20)

    best = fwd_bwd(khop_spmm, plan)
    # the banded aggregation on the same 1/P graph: a faster (or slower)
    # local aggregation makes the same comm volume relatively cheaper
    bplan = collate_banded(local, v1=V1, vk=VK).adj.to(device)
    best_banded = fwd_bwd(banded_khop_aggregate, bplan)

    def proj(t):
        return {bw: round(t / (t + comm_bytes / (float(bw) * 1e9)), 4)
                for bw in LINK_GBPS}

    out["ici_projection"] = {
        "workload": f"polymer n={n_nodes}, K={kk}, D={hidden}, "
                    f"{shards} shards",
        "union_edges": edges,
        "halo_rows": sharded.halo,
        "boundary_rows": sharded.boundary_total(),
        "comm_bytes_per_device_per_layer": comm_bytes,
        "full_table_psum_bytes_would_be": psum_bytes,
        "measured_per_layer_fwd_bwd_ms_per_device": round(best * 1e3, 3),
        "efficiency_vs_ici_GBps": proj(best),
        "banded_per_layer_fwd_bwd_ms_per_device":
            round(best_banded * 1e3, 3),
        "banded_efficiency_vs_ici_GBps": proj(best_banded),
        "backend": "none: one device, no process group (the comm bytes "
                   "come from the partition plan)",
        "device": _device_name(device),
        "link_GBps_assumed": LINK_GBPS,
    }


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mode", choices=["weak", "ici", "both"],
                   default="both")
    p.add_argument("--n_nodes", type=int, default=65536)
    p.add_argument("--shards", type=int, default=8,
                   help="shards of the link projection's partition")
    p.add_argument("--ranks", default="1,2,4,8",
                   help="rank counts P of the weak mode")
    p.add_argument("--device", default="cuda",
                   help="torch device; without CUDA the run raises unless "
                        "--device cpu is given")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    set_full_f32()
    out = {}
    if args.mode in ("weak", "both"):
        _weak(out, [int(r) for r in args.ranks.split(",")], device)
    if args.mode in ("ici", "both"):
        _ici(out, args.n_nodes, args.shards, device)
    print(json.dumps(out, indent=1), flush=True)
    return out


if __name__ == "__main__":
    main()
