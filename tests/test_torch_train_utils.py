"""The port's training utilities against the JAX package: the plateau
schedule in max mode, the checkpoint saver's eviction rule, a bitwise
checkpoint round trip, a warm-started Trainer against one continued in
process, EMA, seeds and meters, one eval under ``bn_train_mode_eval``
on carried weights (the running statistics left as they were, per batch
and resident), and ``sched_on="loss"``.  Losses rtol 1e-4, activations
atol 1e-5 / rtol 1e-4 (f32; the two sides sum in different orders)."""
import math
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kpgnn_tpu.train.checkpoint import CheckpointSaver as JSaver
from kpgnn_tpu.train.ema import EMA as JEMA
from kpgnn_tpu.train.lr import ReduceLROnPlateau as JPlateau
from kpgnn_tpu.train.loop import eval_step_body as jeval_step_body
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu.utils.meters import AverageMeter as JMeter
from kpgnn_tpu.utils.seed import get_seed as jget_seed
from kpgnn_tpu.utils.seed import seed_everything as jseed_everything
import kpgnn_tpu.models as jmodels
from kpgnn_tpu_torch.data.expressiveness import generate_csl
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.nn.inits import init_parameters
from kpgnn_tpu_torch.prep.khop import KHopConfig, extract_graphs
from kpgnn_tpu_torch.train.checkpoint import (CheckpointSaver,
                                              load_checkpoint,
                                              save_checkpoint)
from kpgnn_tpu_torch.train.config import TrainConfig
from kpgnn_tpu_torch.train.ema import EMA
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.train.loop import Trainer, eval_step, train_step
from kpgnn_tpu_torch.train.lr import ReduceLROnPlateau
from kpgnn_tpu_torch.train.resident import (build_coo_store,
                                            build_dense_store,
                                            epoch_index_chunks,
                                            make_resident_eval)
from kpgnn_tpu_torch.train.state import make_optimizer
from kpgnn_tpu_torch.utils import get_available_devices
from kpgnn_tpu_torch.utils.convert import params_from_flax
from kpgnn_tpu_torch.utils.meters import AverageMeter
from kpgnn_tpu_torch.utils.seed import get_seed, seed_everything
from tests.test_torch_csl import CSL_SMALL, csl_batches
from tests.test_torch_layers import flat

torch.set_num_threads(1)

METRICS = [0.5, 0.4, 0.4, 0.45, 0.41, 0.40004, 0.39, 0.39, 0.7, 0.39, 0.1,
           0.1, 0.1, 0.1, 0.2, 0.05]


@pytest.mark.parametrize("mode", ["min", "max"])
@pytest.mark.parametrize("patience", [0, 2])
def test_plateau_schedule_equals_jax(mode, patience):
    """The same lr after every step of a fixed metric sequence, in both
    modes (torch's rel threshold: best * (1 -+ 1e-4))."""
    ours = ReduceLROnPlateau(factor=0.5, patience=patience, min_lr=0.01,
                             mode=mode)
    theirs = JPlateau(factor=0.5, patience=patience, min_lr=0.01, mode=mode)
    assert ours.best == theirs.best
    lr_o = lr_t = 1.0
    lrs = []
    for m in METRICS:
        lr_o, lr_t = ours.step(m, lr_o), theirs.step(m, lr_t)
        assert (lr_o, ours.best, ours.num_bad) == (lr_t, theirs.best,
                                                   theirs.num_bad)
        lrs.append(lr_o)
    assert len(set(lrs)) > 1                    # the schedule decayed


def test_plateau_schedule_rejects_an_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        ReduceLROnPlateau(mode="mean")


@pytest.mark.parametrize("maximize,keep", [(False, 3), (True, 3),
                                           (False, 1), (True, 2)])
def test_checkpoint_saver_keeps_the_jax_savers_files(tmp_path, maximize,
                                                     keep):
    """Ties included: the same epochs stay on disk and the same best, by
    the JAX saver's heap of +-metric; file names of the port's own."""
    model = torch.nn.Linear(2, 1)
    ours = CheckpointSaver(str(tmp_path / "t"), keep, maximize)
    theirs = JSaver(str(tmp_path / "j"), keep, maximize)
    for step, m in enumerate(METRICS):
        ours.save(step, model, None, m)
        theirs.save(step, {"w": np.zeros(1, np.float32)}, m)
        kept_t = sorted(os.listdir(tmp_path / "j"))
        kept_o = sorted(os.listdir(tmp_path / "t"))
        assert ([f.replace(".ckpt", ".pt") for f in kept_t] == kept_o)
        assert ours.best == theirs.best
    assert "best.pt" in kept_o and len(kept_o) == keep + 1
    assert not any(f.endswith(".ckpt") for f in kept_o)


def adamw_after_steps(seed=0, steps=2):
    model = torch.nn.Sequential(torch.nn.Linear(4, 8),
                                torch.nn.BatchNorm1d(8),
                                torch.nn.Linear(8, 1))
    torch.manual_seed(seed)
    opt = make_optimizer(model.parameters(), 1e-3, l2_wd=1e-2)
    x = torch.randn(16, 4)
    for _ in range(steps):
        opt.zero_grad()
        model(x).square().mean().backward()
        opt.step()
    return model, opt


def test_checkpoint_round_trip_is_bitwise(tmp_path):
    """Every parameter, buffer (running stats, num_batches_tracked) and
    optimizer-state tensor (moments, step), and the param groups."""
    model, opt = adamw_after_steps()
    path = str(tmp_path / "c" / "x.pt")
    save_checkpoint(path, model, opt, {"step": 7, "metric": 0.25})
    assert not os.path.exists(path + ".tmp")
    fresh, fopt = adamw_after_steps(seed=1, steps=1)
    meta = load_checkpoint(path, fresh, fopt)
    assert meta == {"step": 7, "metric": 0.25}
    a, b = model.state_dict(), fresh.state_dict()
    assert a.keys() == b.keys()
    for k in a:
        assert torch.equal(a[k], b[k]), k
    sa, sb = opt.state_dict(), fopt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            assert v.dtype == sb["state"][i][k].dtype
            assert torch.equal(v, sb["state"][i][k]), (i, k)


SMALL = dict(model_name="KPGIN", hidden_size=8, num_layer=2, K=2,
             max_pe_num=1000, max_edge_count=1000, max_hop_num=2,
             max_distance_count=1000, drop_prob=0.0,
             input_encoder=("linear", 1), task="graph_classification",
             output_size=10, pooling_method="sum")


def small_csl_graphs():
    """Two CSL graphs of each class, prepped at K=2."""
    raw = generate_csl()
    picks = [raw[c * 15 + i] for i in range(2) for c in range(10)]
    for r in picks:
        r["x"] = np.ones((r["num_nodes"], 1), np.float32)
    return extract_graphs(picks, KHopConfig(
        K=2, kernel="spd", max_edge_attr_num=1000, max_hop_num=2,
        max_edge_type=1, max_edge_count=1000, max_distance_count=1000))


@pytest.fixture(scope="module")
def csl_small():
    return small_csl_graphs()


def fit(graphs, epochs, mode="coo", **kw):
    tl = GraphLoader(graphs, 5, mode=mode, v1=3, vk=1002)
    vl = GraphLoader(graphs[:10], 5, mode=mode, v1=3, vk=1002)
    cfg = TrainConfig(lr=1e-2, num_epochs=epochs, patience=0, factor=0.5,
                      **kw.pop("cfg", {}))
    trainer = Trainer(make_model(ModelConfig(**SMALL)), cfg,
                      loss="cross_entropy", device="cpu", **kw)
    rows = []
    _, res = trainer.fit(tl, vl, seed=3,
                         epoch_callback=lambda e, m, r: rows.append(r))
    return res, rows


def test_warm_started_trainer_equals_one_continued_in_process(
        csl_small, tmp_path):
    """A Trainer warm-started from the checkpoint of epoch 0 takes the
    same steps as one that trains on: model, Adam moments, step counts
    and lr come back bit for bit."""
    _, first = fit(csl_small, 1, checkpoint_dir=str(tmp_path / "ck"),
                   use_scheduler=False)
    assert sorted(os.listdir(tmp_path / "ck")) == ["best.pt", "step_0.pt"]
    _, warm = fit(csl_small, 1, cfg=dict(load_path=str(tmp_path / "ck" /
                                                       "best.pt")),
                  use_scheduler=False)
    _, both = fit(csl_small, 2, use_scheduler=False)
    np.testing.assert_array_equal(first[0]["step_losses"],
                                  both[0]["step_losses"])
    np.testing.assert_array_equal(warm[0]["step_losses"],
                                  both[1]["step_losses"])
    assert warm[0]["val_loss"] == both[1]["val_loss"]


def test_trainer_saves_under_save_dir_with_save_checkpoints(csl_small,
                                                           tmp_path):
    """``cfg.save_checkpoints`` keeps the best epochs under
    <save_dir>/checkpoints, best by validation accuracy in max mode."""
    res, rows = fit(csl_small, 3, metric_mode="max", max_checkpoints=1,
                    cfg=dict(save_checkpoints=True, save_dir=str(tmp_path)))
    files = sorted(os.listdir(tmp_path / "checkpoints"))
    assert "best.pt" in files and len(files) == 2
    meta = torch.load(tmp_path / "checkpoints" / "best.pt",
                      weights_only=True)["meta"]
    assert meta == {"step": res["best_epoch"], "metric": res["best_val"]}
    assert res["best_val"] == max(r["val_accuracy"] for r in rows)


@pytest.mark.parametrize("sched_on,mode", [("loss", "max"),
                                            ("metric", "max"),
                                            ("metric", "min")])
def test_trainer_schedule_follows_sched_on(csl_small, sched_on, mode):
    """The lr of every epoch is the plateau schedule's over the
    validation loss in min mode (``sched_on="loss"``), else over the
    gated metric in ``metric_mode``: max mode with a scheduler runs."""
    res, rows = fit(csl_small, 6, metric_mode=mode, sched_on=sched_on)

    def schedule(key, sched_mode):
        sched = ReduceLROnPlateau(factor=0.5, patience=0, mode=sched_mode)
        lrs, lr = [], 1e-2
        for r in rows:
            lrs.append(lr)
            lr = sched.step(r[key], lr)
        return lrs
    by_loss = schedule("val_loss", "min")
    by_acc = schedule("val_accuracy", "max")
    assert len(rows) == 6
    assert [r["lr"] for r in rows] == (
        by_loss if sched_on == "loss" or mode == "min" else by_acc)
    # here the validation loss falls every epoch and the accuracy stalls:
    # the two drive different schedules
    assert by_loss != by_acc


def test_ema_equals_jax():
    rng = np.random.default_rng(0)
    start = {k: rng.normal(size=s).astype(np.float32)
             for k, s in (("w", (3, 4)), ("b", (4,)))}
    ours = EMA({k: torch.tensor(v) for k, v in start.items()}, decay=0.9)
    theirs = JEMA({k: jnp.asarray(v) for k, v in start.items()}, decay=0.9)
    for _ in range(5):
        p = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in start.items()}
        so = ours.update({k: torch.tensor(v) for k, v in p.items()})
        st = theirs.update({k: jnp.asarray(v) for k, v in p.items()})
        for k in start:
            np.testing.assert_allclose(so[k].numpy(), np.asarray(st[k]),
                                       rtol=1e-6, atol=1e-7)
    assert np.array_equal(start["w"], start["w"].copy())


def test_seed_and_meter_equal_jax():
    for base, run in ((234, 0), (234, 3), (7, 2), (2**31, 5)):
        assert get_seed(base, run) == jget_seed(base, run)
    seed = get_seed(7, 2)
    seed_everything(seed)
    ours = (random.random(), np.random.rand(3))
    jseed_everything(seed)
    theirs = (random.random(), np.random.rand(3))
    assert ours[0] == theirs[0]
    np.testing.assert_array_equal(ours[1], theirs[1])
    a = torch.rand(2)
    seed_everything(seed)
    assert torch.equal(torch.rand(2), a)        # torch's stream too
    m, jm = AverageMeter(), JMeter()
    for v, n in ((2.0, 1), (4.0, 3), (-1.5, 2)):
        m.update(v, n)
        jm.update(v, n)
        assert (m.sum, m.count, m.avg) == (jm.sum, jm.count, jm.avg)
    m.reset()
    assert (m.sum, m.count, m.avg) == (0.0, 0.0, 0.0)


def test_get_available_devices():
    devs = get_available_devices()
    if torch.cuda.is_available():
        assert [d.type for d in devs] == ["cuda"] * torch.cuda.device_count()
    else:
        assert devs == [torch.device("cpu")]


def buffers(model):
    return {k: v.clone() for k, v in model.named_buffers()}


def assert_same_buffers(a, b):
    assert a.keys() == b.keys() and a
    for k in a:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("backend", ["coo", "pallas"])
def test_bn_train_mode_eval_equals_jax(backend):
    """One eval step with batch-statistics norms against the JAX
    ``eval_step_body(bn_train_mode=True)`` on carried weights (trained
    running statistics, so the two norm modes differ), every buffer
    bit-identical afterwards."""
    jb, tb_coo, tb_plan = csl_batches(n_batches=2)[1]
    tb = tb_coo if backend == "coo" else tb_plan
    jmodel = jmodels.make_model(jmodels.ModelConfig(**CSL_SMALL))
    state, _ = create_train_state(jmodel, jb, jax.random.PRNGKey(0), 1e-3)
    # move the running statistics off their init
    rng = np.random.default_rng(1)
    leaves, tdef = jax.tree_util.tree_flatten(state.batch_stats)
    state = state.replace(batch_stats=jax.tree_util.tree_unflatten(tdef, [
        jnp.asarray(np.asarray(x) + rng.uniform(0.5, 1.5, x.shape).astype(
            np.float32)) for x in leaves]))
    variables = flat(state.variables)
    model = make_model(ModelConfig(**CSL_SMALL))
    model.load_state_dict(params_from_flax(variables), strict=True)
    for bn_train in (True, False):
        want = jax.jit(jeval_step_body(jmodel, "cross_entropy",
                                       bn_train_mode=bn_train))(state, jb)
        before = buffers(model)
        got = eval_step(model, tb, "cross_entropy", bn_train_mode=bn_train)
        assert_same_buffers(before, buffers(model))
        np.testing.assert_allclose(float(got["loss_sum"]),
                                   float(want["loss_sum"]), rtol=1e-4)
        assert int(got["correct"]) == int(want["correct"])
        assert float(got["count"]) == float(want["count"])
        if bn_train:
            train_mode_loss = float(got["loss_sum"])
    assert abs(train_mode_loss - float(got["loss_sum"])) > 1e-3


@pytest.mark.parametrize("mode", ["dense", "coo"])
def test_bn_train_mode_eval_resident_leaves_the_buffers(csl_small, mode):
    """The resident eval under ``bn_train_mode`` gives the per-batch
    eval's metrics, and neither moves the running statistics."""
    model = init_parameters(make_model(ModelConfig(**SMALL)), 0)
    opt = make_optimizer(model.parameters(), 1e-2)
    loader = GraphLoader(csl_small, 5, mode=mode, v1=3, vk=1002)
    for b in loader:                    # trained running statistics
        train_step(model, opt, b, "cross_entropy")
    store = (build_dense_store(csl_small, loader.n_slot, 3, 1002, device="cpu")
             if mode == "dense" else build_coo_store(csl_small, device="cpu"))
    chunks = epoch_index_chunks(np.arange(len(csl_small)), 5,
                                store.num_graphs)
    before = buffers(model)
    res = make_resident_eval(model, "cross_entropy",
                             bn_train_mode=True)(store, chunks)
    assert_same_buffers(before, buffers(model))
    from kpgnn_tpu_torch.train.loop import evaluate
    per = evaluate(model, list(loader), "cross_entropy", bn_train_mode=True)
    assert_same_buffers(before, buffers(model))
    assert res["count"] == per["count"] == len(csl_small)
    np.testing.assert_allclose(res["loss"], per["loss"], rtol=1e-4)
    assert res["accuracy"] == per["accuracy"]
    running = evaluate(model, list(loader), "cross_entropy")
    assert not math.isclose(running["loss"], per["loss"], rel_tol=1e-3)
