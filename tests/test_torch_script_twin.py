"""Whole runs of the port's ``train_zinc.main`` and ``train_qm9.main``
against the JAX package's, on the CPU, on one written fixture.

Both sides start from the JAX package's init of the script's model,
written once as a checkpoint of each package (``write_jax_init``) that
the script's ``--load_path`` reads; dropout is 0 (the scripts' default).
ZINC runs ``--runs 2`` of ``TINY_ARGS`` for 10 epochs (this small model
improves its validation loss in each of its first 6, and the plateau
schedule first fires at epoch 7 or 8); QM9 its one run on a
24-molecule fixture (``--virtual_node --use_rd``, attention combine and
pooling, task 0).  Both run per-batch epochs (``--resident off``: the
JAX package's resident epochs keep their step losses inside one scan).
As in tests/test_torch_fit_twin.py, the JAX script runs once and the
port's twice:

* the free run: each run's learning rates (as the f32 the JAX optimizer
  stores) and best epoch, exactly;
* the resynchronized run, whose epoch hook loads the JAX run's weights,
  running statistics and Adam moments of the end of each epoch but a
  run's last: every step loss and ``train_loss`` at rtol 1e-5, the
  learning rates and best epochs exactly, and the leaves further than
  1e-4 from the JAX run's after the last epoch only those whose exact
  gradient is 0 and the running statistics (the reasons and tolerances
  are tests/test_torch_fit_twin.py's).

Besides, per run: the seeds, ``--seed + run`` for the shuffle and the
init on both sides; on each of the three runs the best-val protocol
(a test metric is logged at exactly the epochs whose validation loss
beats every earlier one, the same epochs on all three, and ``best_test``
is the one logged at ``best_epoch``); the port's evaluation of the JAX
run's best-epoch weights on the script's own test split equals the JAX
run's best-val test metric at rtol 1e-5; and the final reported test
MAE of the JAX script is the mean of those (ZINC) or that metric times
the train targets' std (QM9), which the port's script reproduces from
its own split and targets at rtol 1e-5.

The port's own metrics read weights one epoch of f32 drift away from
the JAX run's (each epoch starts from the JAX state and then runs on its
own), so they are held at DRIFT = 1e-2: the resynchronized run's
validation metric of every epoch, each run's ``best_test`` and the
value ``main`` returns, against the JAX run's.  The largest one-epoch
gap measured here is 3.3e-3 (validation 2.9e-3, test 3.3e-3 over 44
readings of both scripts; the returned MAEs part by 1.4e-4 and
1.6e-4), and a test metric taken from another epoch than the best
parts by 1e-1 or more.  The returned value itself must be the mean of
the port's runs' ``best_test`` (ZINC) or its MAE times the std (QM9),
on the free and the resynchronized runs.
"""
import os

import jax
import numpy as np
import torch

import kpgnn_tpu.models as jmodels
import kpgnn_tpu.prep.khop as jkhop
import kpgnn_tpu.scripts.common as jcommon
import kpgnn_tpu.scripts.train_qm9 as jqm9
import kpgnn_tpu.scripts.train_zinc as jzinc
import kpgnn_tpu.train.checkpoint as jckpt
import kpgnn_tpu.train.loop as jloop
from kpgnn_tpu.data.molecules import load_qm9 as jload_qm9
from kpgnn_tpu.data.molecules import load_zinc as jload_zinc
from kpgnn_tpu.train.loader import GraphLoader as JGraphLoader
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.models.factory import make_model
from kpgnn_tpu_torch.scripts import common as tcommon
from kpgnn_tpu_torch.scripts import train_qm9 as tqm9
from kpgnn_tpu_torch.scripts import train_zinc as tzinc
from kpgnn_tpu_torch.train import checkpoint as tckpt
from kpgnn_tpu_torch.train import loop as tloop
from kpgnn_tpu_torch.train.state import make_optimizer
from tests.test_torch_fit_twin import (APART, RTOL, eval_keys,
                                       load_jax_state, lrs, port_state,
                                       zero_gradient_or_stat)
from tests.test_torch_model import TINY_ARGS, write_zinc_fixture
from tests.test_torch_qm9 import write_qm9_fixture

torch.set_num_threads(1)
SCRIPTS = {"zinc": (tzinc, ("embedding", 21)), "qm9": (tqm9, None)}
DRIFT = 1e-2


def script_args(task, argv):
    """The script's parsed flags (the port's parser: the JAX script's
    flags plus ``--device``) and its model's input encoder."""
    module, encoder = SCRIPTS[task]
    args = module.parser().parse_args(argv)
    return args, encoder or ("qm9", int(args.use_pos))


def write_jax_init(out_dir, task, argv, seed=None):
    """The JAX package's initial TrainState of the ``task`` script's model
    (``train_zinc`` or ``train_qm9`` under ``argv``), drawn as the JAX
    script's run 0 draws it from ``--seed`` (or ``seed``), written as a
    JAX checkpoint and as a port checkpoint (weights, running statistics
    and a fresh Adam of the same lr) for each side's ``--load_path``.
    Returns (JAX checkpoint path, port checkpoint path)."""
    args, encoder = script_args(task, argv)
    seed = args.seed if seed is None else seed
    root = os.path.join(args.dataset_dir, "ZINC" if task == "zinc" else "QM9")
    raws = (jload_zinc(root)["train"] if task == "zinc"
            else jload_qm9(root))[:4]
    cfg = jcommon.khop_config(args)
    graphs = [jkhop.extract_khop(
        r["num_nodes"], r["edge_index"], r["edge_attr"], cfg, x=r["x"],
        y=np.asarray(r["y"], np.float32).reshape(-1)[:1],
        **{k: r[k] for k in ("z", "pos") if k in r}) for r in raws]
    jmcfg = jcommon.model_config(args, input_encoder=encoder,
                                 task="graph_regression", output_size=1)
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    state, _ = create_train_state(
        jmodels.make_model(jmcfg), JGraphLoader(graphs, 4).example(),
        init_rng, args.lr, args.l2_wd)
    os.makedirs(out_dir, exist_ok=True)
    jpath = os.path.join(out_dir, f"jax_init_{task}_{seed}.ckpt")
    tpath = os.path.join(out_dir, f"jax_init_{task}_{seed}.pt")
    jckpt.save_checkpoint(jpath, state)
    model = make_model(tcommon.model_config(
        args, input_encoder=encoder, task="graph_regression", output_size=1))
    model.load_state_dict(port_state(state.variables), strict=True)
    tckpt.save_checkpoint(tpath, model,
                          make_optimizer(model.parameters(), args.lr,
                                         args.l2_wd))
    return jpath, tpath


class Runs:
    """What each run of a script's Trainer saw: loader seeds, fit seed,
    the history, and (JAX) the TrainState of each epoch's end or (port)
    the model and its test batches."""

    def __init__(self):
        self.runs, self.loader_seeds, self.steps = [], [], []

    def loader(self, cls):
        runs = self

        class Recording(cls):
            def __init__(self, graphs, batch_size, shuffle=False, seed=0,
                         **kw):
                if shuffle:
                    runs.loader_seeds.append(seed)
                super().__init__(graphs, batch_size, shuffle=shuffle,
                                 seed=seed, **kw)
        return Recording


def run_jax(monkeypatch, task, argv):
    """The JAX script's main under ``argv``: (its result, Runs)."""
    rec = Runs()
    fit, make_step = jloop.Trainer.fit, jloop.make_train_step

    def recording_fit(self, tl, vl=None, el=None, rng=None,
                      epoch_callback=None):
        run = {"seed": np.asarray(rng), "states": []}
        rec.runs.append(run)
        state, res = fit(self, tl, vl, el, rng=rng, epoch_callback=lambda
                         e, s, row: run["states"].append(jax.device_get(s)))
        run["res"] = res
        return state, res

    def recording_step(*a, **k):
        step = make_step(*a, **k)

        def run(state, batch, rng):
            state, m = step(state, batch, rng)
            rec.steps.append(float(m["loss_sum"]) / float(m["count"]))
            return state, m
        return run

    module = jzinc if task == "zinc" else jqm9
    monkeypatch.setattr(jloop.Trainer, "fit", recording_fit)
    monkeypatch.setattr(jloop, "make_train_step", recording_step)
    monkeypatch.setattr(module, "GraphLoader", rec.loader(JGraphLoader))
    result = module.main(argv)
    monkeypatch.undo()
    return result, rec


def run_port(monkeypatch, task, argv, jrec=None):
    """The port's script main under ``argv`` on the CPU: (its result,
    Runs).  With ``jrec`` (the JAX script's Runs), each run's epochs but
    its last end by loading the JAX run's state of that epoch."""
    rec = Runs()
    fit, make_opt = tloop.Trainer.fit, tloop.make_optimizer
    opts = []

    def recording_fit(self, tl, vl=None, el=None, seed=None,
                      epoch_callback=None):
        r = len(rec.runs)
        run = {"seed": seed, "test": list(el)}
        rec.runs.append(run)

        def hook(epoch, model, row):
            if jrec is not None and epoch < self.cfg.num_epochs - 1:
                load_jax_state(model, opts[-1], jrec.runs[r]["states"][epoch])

        model, res = fit(self, tl, vl, el, seed=seed, epoch_callback=hook)
        run.update(res=res, model=model, loss=self.loss,
                   metric=self.eval_metric)
        return model, res

    def recording_optimizer(*a, **k):
        opts.append(make_opt(*a, **k))
        return opts[-1]

    monkeypatch.setattr(tloop.Trainer, "fit", recording_fit)
    monkeypatch.setattr(tloop, "make_optimizer", recording_optimizer)
    monkeypatch.setattr(tcommon if task == "zinc" else tqm9, "GraphLoader",
                        rec.loader(tcommon.GraphLoader))
    module = tzinc if task == "zinc" else tqm9
    result = module.main(argv + ["--device", "cpu"])
    monkeypatch.undo()
    return result, rec


def assert_best_val_protocol(res):
    """A test metric logged at exactly the epochs whose validation loss
    beats every earlier one; ``best_test`` the one at ``best_epoch``.
    Returns those epochs."""
    history, best, logged = res["history"], float("inf"), []
    for e, row in enumerate(history):
        improved = row["val_loss"] < best
        best = min(best, row["val_loss"])
        assert bool(eval_keys(row, "test")) == improved, \
            f"epoch {e}: val improved {improved}, test logged {not improved}"
        if improved:
            logged.append(e)
    assert logged and logged[-1] == res["best_epoch"]
    want = eval_keys(history[res["best_epoch"]], "test")
    assert {k: v for k, v in res["best_test"].items() if k != "count"} \
        == want
    return logged


def assert_script_twins(monkeypatch, tmp_path, task, argv, metric):
    """The three script runs from one JAX init and the checks of the
    module docstring.  Returns (JAX result, the port's free and
    resynchronized results, their Runs, the port's evaluations of the JAX
    runs' best weights)."""
    jpath, tpath = write_jax_init(str(tmp_path / "init"), task, argv)
    save = ["--save_dir", str(tmp_path / "save")]
    jresult, jrec = run_jax(monkeypatch, task,
                            argv + save + ["--load_path", jpath])
    targv = argv + save + ["--load_path", tpath]
    fresult, free = run_port(monkeypatch, task, targv)
    tresult, trec = run_port(monkeypatch, task, targv, jrec=jrec)

    args, _ = script_args(task, argv)
    seeds = [args.seed + r for r in range(len(jrec.runs))]
    assert len(jrec.runs) == len(free.runs) == len(trec.runs) == args.runs
    assert jrec.loader_seeds == free.loader_seeds == trec.loader_seeds \
        == seeds
    assert [r["seed"] for r in trec.runs] == seeds
    for j, s in zip(jrec.runs, seeds):
        np.testing.assert_array_equal(j["seed"], jax.random.PRNGKey(s))

    steps = iter(jrec.steps)
    fired, evaluated = False, []
    key = "mae" if metric == "mae" else "loss"
    for j, f, t in zip(jrec.runs, free.runs, trec.runs):
        jh, th = j["res"]["history"], t["res"]["history"]
        assert lrs(f["res"]["history"]) == lrs(th) == lrs(jh)
        assert (f["res"]["best_epoch"] == t["res"]["best_epoch"]
                == j["res"]["best_epoch"])
        assert (assert_best_val_protocol(j["res"])
                == assert_best_val_protocol(f["res"])
                == assert_best_val_protocol(t["res"]))
        fired |= len(set(lrs(jh))) > 1
        for e, (a, b) in enumerate(zip(jh, th)):
            want = [next(steps) for _ in b["step_losses"]]
            np.testing.assert_allclose(b["step_losses"], want, rtol=RTOL,
                                       err_msg=f"epoch {e} step losses")
            np.testing.assert_allclose(b["train_loss"], a["train_loss"],
                                       rtol=RTOL, err_msg=f"epoch {e}")
            np.testing.assert_allclose(b[f"val_{key}"], a[f"val_{key}"],
                                       rtol=DRIFT, err_msg=f"epoch {e} val")
        np.testing.assert_allclose(t["res"]["best_test"][key],
                                   j["res"]["best_test"][key], rtol=DRIFT)
        twin, final = t["model"], port_state(j["states"][-1].variables)
        far = [n for n, v in twin.state_dict().items()
               if v.is_floating_point()
               and float((v.double() - final[n].double()).abs().max())
               > APART]
        assert all(zero_gradient_or_stat(n) for n in far), far
        # the port's evaluation of the JAX run's best-epoch weights
        best = j["states"][j["res"]["best_epoch"]]
        twin.load_state_dict(port_state(best.variables), strict=True)
        got = tloop.evaluate(twin, t["test"], t["loss"], t["metric"])
        np.testing.assert_allclose(got[key], j["res"]["best_test"][key],
                                   rtol=RTOL)
        evaluated.append(got[key])
    assert next(steps, None) is None
    assert fired, "the plateau schedule never fired"
    np.testing.assert_allclose(tresult, jresult, rtol=DRIFT)
    return jresult, (fresult, tresult), (free, trec), evaluated


def best_tests(runs, key):
    return [r["res"]["best_test"][key] for r in runs.runs]


def test_train_zinc_main_twin(monkeypatch, tmp_path):
    write_zinc_fixture(str(tmp_path), (24, 8, 8))
    argv = ["--dataset_dir", str(tmp_path), "--cache_dir",
            str(tmp_path / "cache")] + TINY_ARGS + [
        "--runs", "2", "--num_epochs", "10", "--patience", "1",
        "--resident", "off"]
    jresult, results, runs, evaluated = assert_script_twins(
        monkeypatch, tmp_path, "zinc", argv, "loss")
    np.testing.assert_allclose(np.mean(evaluated), jresult, rtol=RTOL)
    for result, rec in zip(results, runs):
        np.testing.assert_allclose(result, np.mean(best_tests(rec, "loss")),
                                   rtol=1e-12)


def test_train_qm9_main_twin(monkeypatch, tmp_path):
    write_qm9_fixture(tmp_path, 24, seed=5)
    argv = ["--dataset_dir", str(tmp_path), "--cache_dir",
            str(tmp_path / "cache"), "--K", "2", "--num_layer", "2",
            "--hidden_size", "16", "--batch_size", "4", "--num_epochs", "5",
            "--patience", "1", "--virtual_node", "--use_rd",
            "--resident", "off"]
    jresult, results, runs, evaluated = assert_script_twins(
        monkeypatch, tmp_path, "qm9", argv, "mae")
    # the script's train-target std, from its own split of the fixture
    args, _ = script_args("qm9", argv + ["--device", "cpu"])
    (train, _, _), std = tqm9.task_splits(
        tcommon.prepare(tqm9.load(args), args, "QM9"), args)
    np.testing.assert_allclose(evaluated[0] * std, jresult, rtol=RTOL)
    for result, rec in zip(results, runs):
        np.testing.assert_allclose(result, best_tests(rec, "mae")[0] * std,
                                   rtol=1e-6)
