"""The port's Trainer over a process group and ``--parallel`` through the
entry points, on the CPU.

* ``Trainer(mesh=..., parallel_mode=...)`` in two spawned gloo ranks:
  data-parallel per batch and resident (a COO store), node-sharded on
  the kernel plan's plain version and on COO: two epochs each, finite
  losses, every rank's history and final parameters bit for bit the
  same, and a first step equal to the one-device forward over the
  first group's batches (data: the summed losses over the summed
  counts; node: the whole first batch);
* ``train_zinc --device cpu --parallel data|node`` (a group of one in
  this process; data on dense, resident, and on the kernel plan per
  batch; node on COO): the first step equals the same run without
  ``--parallel`` on the kernel plan (rtol 1e-4).
"""
import math

import numpy as np
import pytest
import torch
import torch.distributed as dist

from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.parallel import mesh as tmesh
from kpgnn_tpu_torch.train.config import TrainConfig
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.loop import (Trainer, _batch_target_mask,
                                        _masked_loss)
from tests.test_torch_parallel_dp import model_cfg, port_graphs

torch.set_num_threads(1)

SEED, BATCH = 3, 4
PLANS = {"pallas": {"v1": 5, "vk": 11}}
RUNS = {   # label -> (parallel mode, loader mode, resident, partition plans)
    "data per batch": ("data", "coo", "off", None),
    "data resident": ("data", "coo", "on", None),
    "node kernel plan": ("node", "coo", "off", PLANS),
    "node coo": ("node", "coo", "off", None),
}


def loaders(mode):
    gs = port_graphs(18, 13)
    return (GraphLoader(gs, BATCH, shuffle=True, seed=0, mode=mode),
            GraphLoader(gs[:8], BATCH, mode=mode))


def _trainer_rank(rank, world, cfg):
    mesh = tmesh.make_mesh(("data",))
    out = {}
    for label, (pmode, lmode, resident, plans) in RUNS.items():
        tl, vl = loaders(lmode)
        trainer = Trainer(make_model(ModelConfig(**cfg)),
                          TrainConfig(lr=1e-2, num_epochs=2,
                                      batch_size=BATCH, seed=SEED),
                          loss="mse", device="cpu", resident=resident,
                          mesh=mesh, parallel_mode=pmode,
                          partition_plans=plans)
        model, res = trainer.fit(tl, vl)
        out[label] = (res["history"],
                      {n: p.detach().clone()
                       for n, p in model.named_parameters()})
    return out


def first_step_loss(cfg, batches):
    """The one-device forward's summed masked loss over its summed count,
    from the seeded initial weights."""
    model = init_parameters(make_model(ModelConfig(**cfg)), SEED)
    with torch.no_grad():
        sums = [_masked_loss(model(b, train=True), b.y,
                             _batch_target_mask(b, False), "mse")
                for b in batches]
    return float(sum(s for s, _ in sums) / sum(c for _, c in sums))


def test_trainer_over_two_ranks_in_both_modes():
    cfg = model_cfg("sum_batch_vn")
    results = tmesh.spawn(_trainer_rank, 2, "gloo", args=(cfg,))
    tl, _ = loaders("coo")
    it = iter(tl)
    first = [next(it), next(it)]
    it.close()
    expect = {"data": first_step_loss(cfg, first),
              "node": first_step_loss(cfg, first[:1])}
    for label, (pmode, _, _, _) in RUNS.items():
        hist, params = results[0][label]
        assert len(hist) == 2, label
        for row in hist:
            assert math.isfinite(row["train_loss"]), label
            assert math.isfinite(row["val_loss"]), label
        # 18 graphs: 5 batches, 3 data-parallel groups (the last padded)
        # or 5 node-sharded steps
        assert len(hist[0]["step_losses"]) == (3 if pmode == "data" else 5)
        np.testing.assert_allclose(hist[0]["step_losses"][0],
                                   expect[pmode], rtol=1e-5, err_msg=label)
        other_hist, other_params = results[1][label]
        for a, b in zip(hist, other_hist):
            assert a["train_loss"] == b["train_loss"], label
            assert a["val_loss"] == b["val_loss"], label
        for n, p in params.items():
            assert torch.equal(p, other_params[n]), (label, n)


@pytest.mark.parametrize("flag", [["--parallel", "data", "--backend",
                                   "dense"],
                                  ["--parallel", "data", "--resident",
                                   "off"],
                                  ["--parallel", "node", "--backend",
                                   "coo"]])
def test_train_zinc_parallel_on_cpu(tmp_path, flag):
    from kpgnn_tpu_torch.scripts import train_zinc
    from tests.test_torch_model import TINY_ARGS, write_zinc_fixture

    write_zinc_fixture(str(tmp_path), (24, 8, 8))
    first = {}
    for label, extra in (("parallel", flag), ("one device", [])):
        rows = []
        argv = (["--dataset_dir", str(tmp_path), "--save_dir",
                 str(tmp_path / label), "--device", "cpu"]
                + (["--backend", "pallas"] if "--backend" not in extra
                   else []) + extra + TINY_ARGS)
        try:
            mae = train_zinc.main(argv, epoch_callback=lambda e, m, row:
                                  rows.append(row))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        assert math.isfinite(mae)
        assert len(rows) == 1 and np.isfinite(rows[0]["step_losses"]).all()
        first[label] = rows[0]["step_losses"][0]
    np.testing.assert_allclose(first["parallel"], first["one device"],
                               rtol=1e-4)
