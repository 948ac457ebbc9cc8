"""Whole runs of the port's training scripts against the JAX package's,
on the CPU, on one written fixture or the scripts' generated data: here
``train_zinc`` and ``train_qm9``; tests/test_torch_script_twin_{prime,
counting,graph_property,node_property}.py run the QM9 sweep's KPGINPrime
K=16 config and the generated benchmarks through the same machinery
(``SCRIPTS``), and their ``_steps`` files the same at several steps an
epoch (``assert_steps_twin``).

Both sides start from the JAX package's init of the script's model,
written once as a checkpoint of each package (``write_jax_init``) that
the script's ``--load_path`` reads; dropout is 0 (the scripts' default).
ZINC runs ``--runs 2`` of ``TINY_ARGS`` for 10 epochs (this small model
improves its validation loss in each of its first 6, and the plateau
schedule first fires at epoch 7 or 8); QM9 its one run on a
24-molecule fixture (``--virtual_node --use_rd``, attention combine and
pooling, task 0).  All run per-batch epochs (``--resident off``: the
JAX package's resident epochs keep their step losses inside one scan);
on the kernel plan the JAX side runs the kernel's plain reference
(``pallas_spmm._gather_reference``, as tests/test_torch_fit_twin.py).
As in tests/test_torch_fit_twin.py, the JAX script runs once and the
port's twice:

* the free run: each run's learning rates (as the f32 the JAX optimizer
  stores) and best epoch, exactly;
* the resynchronized run, whose epoch hook loads the JAX run's weights,
  running statistics and Adam moments of the end of each epoch but a
  run's last: every step loss and ``train_loss`` at rtol 1e-5, the
  learning rates and best epochs exactly, and the leaves further than
  1e-4 from the JAX run's after the last epoch only those whose exact
  gradient is 0 and the running statistics (``zero_gradient_or_stat``;
  the reasons and tolerances are tests/test_torch_fit_twin.py's).

ZINC and QM9 hold those tolerances as they stand.  The twins of the
generated benchmarks and of the KPGINPrime config ask for the JAX
package's own gap (``witness``): each epoch of the JAX run again from
the state it started at with every weight moved one ulp
(``WITNESS_MOVES``: up, down, and six draws of either), through the
run's jitted step on the same batches, then its validation and test
metrics (``epoch_witness``); at several steps an epoch
(``assert_steps_twin``) also the same epochs from the unmoved state in
float64.  Of the witnesses, the one furthest from the JAX run's value
counts, element by element, and a tolerance is the larger of PR 13's
and twice that gap (``assert_within_spread``, ``drift``); a leaf's
largest distance from the JAX run's after the last epoch may be up to
twice the witnesses' largest on that leaf (``assert_leaves_apart``).

Besides, per run: the seeds, ``--seed + run`` for the shuffle and the
init on both sides; on each of the three runs the best-val protocol
(a test metric is logged at exactly the epochs whose validation loss
beats every earlier one, the same epochs on all three, and ``best_test``
is the one logged at ``best_epoch``); the port's evaluation of the JAX
run's best-epoch weights on the script's own test split equals the JAX
run's best-val test metric at rtol 1e-5; and the final reported metric
of the JAX script (ZINC's mean of those, QM9's that metric times the
train targets' std) the port's script reproduces from its own split and
targets at rtol 1e-5.

The port's own metrics read weights one epoch of f32 drift away from
the JAX run's (each epoch starts from the JAX state and then runs on its
own), so they are held at DRIFT = 1e-2 (with ``witness``, or twice
the JAX package's own gap where that is wider: ``drift``): the
resynchronized run's
validation metric of every epoch, each run's ``best_test`` and the
value ``main`` returns, against the JAX run's.  At the learning rates of
ZINC and QM9 (1e-3) the largest one-epoch gap measured here is 3.3e-3
(validation 2.9e-3, test 3.3e-3 over 44 readings of both scripts; the
returned MAEs part by 1.4e-4 and 1.6e-4), and a test metric taken from
another epoch than the best parts by 1e-1 or more.  At the generated
benchmarks' 1e-2, Adam moves each element of exact gradient 0 by about
lr in the direction rounding picks, the batch norms' running means lag
those moves, and one epoch's validation loss parts by up to 5% in the
JAX package's own witness.  The returned value itself must be the mean
of the port's runs' ``best_test`` (ZINC) or its MAE times the std (QM9),
on the free and the resynchronized runs.
"""
import copy
import os

import jax
import numpy as np
import torch

import kpgnn_tpu.models as jmodels
import kpgnn_tpu.ops.pallas_spmm as jpallas
import kpgnn_tpu.prep.khop as jkhop
import kpgnn_tpu.scripts.common as jcommon
import kpgnn_tpu.scripts.train_counting as jcounting
import kpgnn_tpu.scripts.train_graph_property as jgprop
import kpgnn_tpu.scripts.train_node_property as jnprop
import kpgnn_tpu.scripts.train_qm9 as jqm9
import kpgnn_tpu.scripts.train_zinc as jzinc
import kpgnn_tpu.train.checkpoint as jckpt
import kpgnn_tpu.train.loop as jloop
from kpgnn_tpu.data import generate_counting_dataset
from kpgnn_tpu.data import generate_property_dataset
from kpgnn_tpu.data.molecules import load_qm9 as jload_qm9
from kpgnn_tpu.data.molecules import load_zinc as jload_zinc
from kpgnn_tpu.train.loader import GraphLoader as JGraphLoader
from kpgnn_tpu.train.state import create_train_state
from kpgnn_tpu_torch.models.factory import make_model
from kpgnn_tpu_torch.scripts import common as tcommon
from kpgnn_tpu_torch.scripts import train_counting as tcounting
from kpgnn_tpu_torch.scripts import train_graph_property as tgprop
from kpgnn_tpu_torch.scripts import train_node_property as tnprop
from kpgnn_tpu_torch.scripts import train_qm9 as tqm9
from kpgnn_tpu_torch.scripts import train_zinc as tzinc
from kpgnn_tpu_torch.train import checkpoint as tckpt
from kpgnn_tpu_torch.train import loop as tloop
from kpgnn_tpu_torch.train.state import make_optimizer, set_lr
from tests.test_torch_fit_twin import (APART, RTOL, SPREAD,
                                       assert_within_spread, eval_keys,
                                       load_jax_state, lrs, one_ulp_up,
                                       port_state, zero_gradient_or_stat)
from tests.test_torch_model import TINY_ARGS, write_zinc_fixture
from tests.test_torch_qm9 import write_qm9_fixture

torch.set_num_threads(1)
# task: (the port's script, the JAX script, the model's input encoder
# (QM9's: from --use_pos), its head)
SCRIPTS = {"zinc": (tzinc, jzinc, ("embedding", 21), "graph_regression"),
           "qm9": (tqm9, jqm9, None, "graph_regression"),
           "counting": (tcounting, jcounting, ("embedding", 2),
                        "graph_regression"),
           "graph_property": (tgprop, jgprop, ("linear", 2),
                              "graph_regression"),
           "node_property": (tnprop, jnprop, ("linear", 2),
                             "node_regression")}
DRIFT = 1e-2
GENERATORS = ("generate_counting_dataset", "generate_property_dataset")
_GENERATED = {}


def cached(gen):
    """``gen`` (a data generator) memoized by its arguments in this
    process, each call handed a deep copy (the scripts write their labels
    into the graphs): the runs of a twin generate their data once a
    package."""
    def call(*a, **k):
        key = (gen, a, tuple(sorted(k.items())))
        if key not in _GENERATED:
            _GENERATED[key] = gen(*a, **k)
        return copy.deepcopy(_GENERATED[key])
    return call


jcounting_data = cached(generate_counting_dataset)
jproperty_data = cached(generate_property_dataset)


def cache_generators(monkeypatch, module):
    """The script ``module``'s data generators through ``cached``."""
    for name in GENERATORS:
        if hasattr(module, name):
            monkeypatch.setattr(module, name, cached(getattr(module, name)))


def script_args(task, argv):
    """The script's parsed flags (the port's parser: the JAX script's
    flags plus ``--device``) and its model's input encoder."""
    module, _, encoder, _ = SCRIPTS[task]
    args = module.parser().parse_args(argv)
    return args, encoder or ("qm9", int(args.use_pos))


def example_raws(task, args):
    """Four raw graphs of the script's data, each ``y`` shaped as its
    loader takes it (a graph label, or node property's (n, 1))."""
    if task in ("zinc", "qm9"):
        root = os.path.join(args.dataset_dir,
                            "ZINC" if task == "zinc" else "QM9")
        raws = (jload_zinc(root)["train"] if task == "zinc"
                else jload_qm9(root))[:4]
    elif task == "counting":
        raws = jcounting_data(args.n_graphs, seed=1234)["train"][:4]
    else:
        raws = jproperty_data(seed=1234, scale=args.data_scale)["train"][:4]
    for r in raws:
        node_y = r.pop("node_y", None)
        r["y"] = (node_y[:, :1] if task == "node_property" else
                  np.asarray(r["y"]).reshape(-1)[:1]).astype(np.float32)
    return raws


def write_jax_init(out_dir, task, argv, seed=None):
    """The JAX package's initial TrainState of the ``task`` script's model
    (``SCRIPTS``' script under ``argv``), drawn as the JAX script's run 0
    draws it from ``--seed`` (or ``seed``), written as a JAX checkpoint
    and as a port checkpoint (weights, running statistics and a fresh
    Adam of the same lr) for each side's ``--load_path``.  Returns (JAX
    checkpoint path, port checkpoint path)."""
    args, encoder = script_args(task, argv)
    head = SCRIPTS[task][3]
    seed = args.seed if seed is None else seed
    cfg = jcommon.khop_config(args)
    graphs = [jkhop.extract_khop(
        r["num_nodes"], r["edge_index"], r.get("edge_attr"), cfg,
        x=r.get("x"), y=r["y"], z=r.get("z"), pos=r.get("pos"))
        for r in example_raws(task, args)]
    jmcfg = jcommon.model_config(args, input_encoder=encoder, task=head,
                                 output_size=1)
    _, init_rng = jax.random.split(jax.random.PRNGKey(seed))
    example = JGraphLoader(graphs, 4, y_is_node_level=head.startswith(
        "node")).example()
    state, _ = create_train_state(jmodels.make_model(jmcfg), example,
                                  init_rng, args.lr, args.l2_wd)
    os.makedirs(out_dir, exist_ok=True)
    jpath = os.path.join(out_dir, f"jax_init_{task}_{seed}.ckpt")
    tpath = os.path.join(out_dir, f"jax_init_{task}_{seed}.pt")
    jckpt.save_checkpoint(jpath, state)
    model = make_model(tcommon.model_config(
        args, input_encoder=encoder, task=head, output_size=1))
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
    """The JAX script's main under ``argv``: (its result, Runs).  On the
    kernel plan the JAX side runs the kernel's plain reference,
    ``pallas_spmm._gather_reference`` (tests/test_torch_fit_twin.py)."""
    rec = Runs()
    fit, make_step = jloop.Trainer.fit, jloop.make_train_step

    def recording_fit(self, tl, vl=None, el=None, rng=None,
                      epoch_callback=None):
        run = {"seed": np.asarray(rng), "states": [], "replay": [],
               "ends": [], "loaders": (vl, el)}
        rec.runs.append(run)

        def on_epoch(e, s, row):
            run["states"].append(jax.device_get(s))
            run["ends"].append(len(run["replay"]))
        state, res = fit(self, tl, vl, el, rng=rng, epoch_callback=on_epoch)
        run["res"] = res
        return state, res

    def recording_step(*a, **k):
        step = make_step(*a, **k)

        def run(state, batch, rng):
            r = rec.runs[-1]
            r["step"] = step
            r["replay"].append((jax.device_get(state), batch, rng))
            state, m = step(state, batch, rng)
            rec.steps.append(float(m["loss_sum"]) / float(m["count"]))
            return state, m
        return run

    def recording_eval(*a, **k):
        rec.runs[-1]["eval"] = make_eval(*a, **k)
        return rec.runs[-1]["eval"]

    module = SCRIPTS[task][1]
    make_eval = jloop.make_eval_step
    monkeypatch.setattr(jloop.Trainer, "fit", recording_fit)
    monkeypatch.setattr(jloop, "make_train_step", recording_step)
    monkeypatch.setattr(jloop, "make_eval_step", recording_eval)
    monkeypatch.setattr(jpallas, "gather_segment_sum",
                        lambda x, csr, **kw: jpallas._gather_reference(x, csr))
    monkeypatch.setattr(module, "GraphLoader", rec.loader(JGraphLoader))
    cache_generators(monkeypatch, module)
    result = module.main(argv)
    monkeypatch.undo()
    return result, rec


def one_ulp_down(state):
    """``state`` with every weight moved one ulp towards -inf."""
    return state.replace(params=jax.tree_util.tree_map(
        lambda p: np.nextafter(p, -np.inf, dtype=p.dtype), state.params))


def ulp_scattered(seed):
    """A move of every weight one ulp up or down, the sign drawn from
    ``seed`` weight by weight."""
    def move(state):
        rng = np.random.default_rng(seed)
        return state.replace(params=jax.tree_util.tree_map(
            lambda p: np.nextafter(p, np.where(
                rng.integers(0, 2, np.shape(p)) == 1, np.inf, -np.inf),
                dtype=p.dtype), state.params))
    return move


# the witnesses' moves: every weight one ulp up, one down, and six
# draws of one ulp either way
WITNESS_MOVES = (one_ulp_up, one_ulp_down) + tuple(
    ulp_scattered(s) for s in range(6))


def as_f64(tree):
    """``tree`` with its floating arrays in float64."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x, np.float64)
        if np.issubdtype(np.asarray(x).dtype, np.floating) else x, tree)


def epoch_witness(run, key, move=one_ulp_up, f64=False):
    """The JAX package against itself, epoch by epoch (``jax_witness`` of
    tests/test_torch_fit_twin.py for a script's run): each epoch of the
    JAX ``run`` again from the state it started at with every weight one
    ulp up (``move``), through the run's jitted step on the same
    batches, then the run's validation and test metrics ``key`` of the
    state it ends at (its jitted evaluation).  With ``f64``, unmoved and
    in float64 (``jax.enable_x64``; the state and batches cast, the same
    step traced again): how far the JAX run's f32 rounding alone carries
    it.  Returns (step losses, per-epoch train losses, validation
    metrics, test metrics, the last epoch's end state as the port's state
    dict)."""
    vl, el = run["loaders"]
    cast = as_f64 if f64 else (lambda tree: tree)
    steps, epochs, vals, tests = [], [], [], []
    with jax.enable_x64(f64):
        for lo, hi in zip([0] + run["ends"][:-1], run["ends"]):
            state = cast(move(run["replay"][lo][0]))
            sums, counts = [], []
            for _, batch, rng in run["replay"][lo:hi]:
                state, m = run["step"](state, cast(batch), rng)
                sums.append(float(m["loss_sum"]))
                counts.append(float(m["count"]))
                steps.append(sums[-1] / counts[-1])
            epochs.append(sum(sums) / max(sum(counts), 1.0))
            vals.append(jloop.evaluate(run["eval"], state, vl)[key])
            tests.append(jloop.evaluate(run["eval"], state, el)[key])
        end = port_state(jax.device_get(state).variables)
    return (np.array(steps), np.array(epochs), np.array(vals),
            np.array(tests), end)


def run_port(monkeypatch, task, argv, jrec=None, follow_lr=False):
    """The port's script main under ``argv`` on the CPU: (its result,
    Runs).  With ``jrec`` (the JAX script's Runs), each run's epochs but
    its last end by loading the JAX run's state of that epoch, and with
    ``follow_lr`` the JAX run's learning rate of the next epoch (the
    port's schedule decides before the epoch's hook)."""
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
                if follow_lr:
                    set_lr(opts[-1],
                           jrec.runs[r]["res"]["history"][epoch + 1]["lr"])

        model, res = fit(self, tl, vl, el, seed=seed, epoch_callback=hook)
        run.update(res=res, model=model, loss=self.loss,
                   metric=self.eval_metric, node_level=self.node_level)
        return model, res

    def recording_optimizer(*a, **k):
        opts.append(make_opt(*a, **k))
        return opts[-1]

    monkeypatch.setattr(tloop.Trainer, "fit", recording_fit)
    monkeypatch.setattr(tloop, "make_optimizer", recording_optimizer)
    monkeypatch.setattr(tqm9 if task == "qm9" else tcommon, "GraphLoader",
                        rec.loader(tcommon.GraphLoader))
    cache_generators(monkeypatch, SCRIPTS[task][0])
    result = SCRIPTS[task][0].main(argv + ["--device", "cpu"])
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


def assert_script_twins(monkeypatch, tmp_path, task, argv, metric,
                        witness=False):
    """The three script runs from one JAX init and the checks of the
    module docstring, at PR 13's tolerances; with ``witness``, widened by
    the JAX package's own gap under one-ulp moves (``WITNESS_MOVES``).
    Returns (JAX result, the port's free and resynchronized results,
    their Runs, the port's evaluations of the JAX runs' best weights)."""
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
    fired, evaluated, result_tol = False, [], DRIFT
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
        jsteps = [next(steps) for b in th for _ in b["step_losses"]]
        ws = [epoch_witness(j, key, move)
              for move in (WITNESS_MOVES if witness else ())]
        wsteps, wtrain, wval = (
            farthest(want, [w[i] for w in ws]) for i, want in enumerate(
                (jsteps, [a["train_loss"] for a in jh],
                 [a[f"val_{key}"] for a in jh])))
        best = j["res"]["best_test"][key]
        wbest = farthest(best, [w[3][j["res"]["best_epoch"]] for w in ws])
        n = 0
        for e, (a, b) in enumerate(zip(jh, th)):
            want = jsteps[n:n + len(b["step_losses"])]
            cut = slice(n, n + len(want))
            n += len(want)
            assert_within_spread(b["step_losses"], want, wsteps[cut],
                                 f"epoch {e} step losses")
            assert_within_spread(b["train_loss"], a["train_loss"],
                                 wtrain[e], f"epoch {e} train loss")
            np.testing.assert_allclose(
                b[f"val_{key}"], a[f"val_{key}"],
                rtol=drift(wval[e], a[f"val_{key}"]), err_msg=f"epoch {e} val")
        tol = drift(wbest, best)
        result_tol = max(result_tol, tol)
        np.testing.assert_allclose(t["res"]["best_test"][key], best,
                                   rtol=tol)
        twin = t["model"]
        assert_leaves_apart(twin, j, ws)
        # the port's evaluation of the JAX run's best-epoch weights
        best = j["states"][j["res"]["best_epoch"]]
        twin.load_state_dict(port_state(best.variables), strict=True)
        got = tloop.evaluate(twin, t["test"], t["loss"], t["metric"],
                             node_level=t["node_level"])
        np.testing.assert_allclose(got[key], j["res"]["best_test"][key],
                                   rtol=RTOL)
        evaluated.append(got[key])
    assert next(steps, None) is None
    assert fired, "the plateau schedule never fired"
    np.testing.assert_allclose(tresult, jresult, rtol=result_tol)
    return jresult, (fresult, tresult), (free, trec), evaluated


def assert_steps_twin(monkeypatch, tmp_path, task, argv, metric):
    """The twin at several steps an epoch (``--runs 1``): the JAX script
    from the JAX init, and the port's run resynchronized each epoch to
    the JAX run's state and learning rate (``follow_lr``), each held to
    the JAX run at the larger of PR 13's tolerances and twice the JAX
    package's own gap, of the one-ulp witnesses and of its float64 replay
    (``epoch_witness``'s ``f64``): every step loss and ``train_loss``,
    each epoch's validation metric, and the leaves after the last epoch
    (``assert_leaves_apart``).  Returns (the JAX run's step losses, the
    port's, the float64 witness's)."""
    jpath, tpath = write_jax_init(str(tmp_path / "init"), task, argv)
    save = ["--save_dir", str(tmp_path / "save")]
    _, jrec = run_jax(monkeypatch, task, argv + save + ["--load_path", jpath])
    _, trec = run_port(monkeypatch, task, argv + save + ["--load_path",
                                                         tpath],
                       jrec=jrec, follow_lr=True)
    (j,), (t,) = jrec.runs, trec.runs
    key = "mae" if metric == "mae" else "loss"
    jh, th = j["res"]["history"], t["res"]["history"]
    assert lrs(th) == lrs(jh)
    jsteps = np.array(jrec.steps)
    tsteps = np.concatenate([b["step_losses"] for b in th])
    assert len(jsteps) > len(jh), "one step an epoch"
    ws = [epoch_witness(j, key, move) for move in WITNESS_MOVES]
    ws.append(epoch_witness(j, key, f64=True))
    wsteps = farthest(jsteps, [w[0] for w in ws])
    def rel(v):
        return np.abs(v - jsteps) / np.abs(jsteps)
    share = rel(tsteps) / np.maximum(RTOL, SPREAD * rel(wsteps))
    print(f"{task} steps twin: the port's largest step-loss gap "
          f"{rel(tsteps).max():.3g}, the JAX run's float64 replay's "
          f"{rel(ws[-1][0]).max():.3g}, the largest share of the "
          f"tolerance {share.max():.3g}")
    assert_within_spread(tsteps, jsteps, wsteps, "step losses")
    train = [a["train_loss"] for a in jh]
    assert_within_spread([b["train_loss"] for b in th], train,
                         farthest(train, [w[1] for w in ws]), "train losses")
    val = [a[f"val_{key}"] for a in jh]
    wval = farthest(val, [w[2] for w in ws])
    for e, (a, b) in enumerate(zip(jh, th)):
        np.testing.assert_allclose(
            b[f"val_{key}"], a[f"val_{key}"],
            rtol=drift(wval[e], a[f"val_{key}"]), err_msg=f"epoch {e} val")
    assert_leaves_apart(t["model"], j, ws)
    return jsteps, tsteps, ws[-1][0]


def apart(a, b):
    """The largest |a - b| of two tensors, in float64."""
    return float((a.double() - b.double()).abs().max())


def assert_leaves_apart(model, run, witnesses):
    """The port's leaves after the last epoch against the JAX ``run``'s:
    further than APART only the leaves ``zero_gradient_or_stat`` names,
    or a leaf no further than SPREAD x the furthest of the ``witnesses``
    (``epoch_witness``es of the run) there."""
    final = port_state(run["states"][-1].variables)
    far = {n: (apart(v, final[n]),
               [apart(w[4][n], final[n]) for w in witnesses])
           for n, v in model.state_dict().items()
           if v.is_floating_point() and not zero_gradient_or_stat(n)}
    far = {n: v for n, v in far.items()
           if v[0] > max([APART] + [SPREAD * g for g in v[1]])}
    assert not far, far


def farthest(want, witnesses):
    """Element by element, the witness furthest from ``want``: the JAX
    package's own largest gap (``want`` itself where there is none)."""
    want = np.asarray(want, np.float64)
    if not witnesses:
        return want
    ws = np.stack([np.asarray(w, np.float64) for w in witnesses])
    pick = np.abs(ws - want).argmax(0)
    return np.take_along_axis(ws, pick[None], 0)[0]


def drift(witness, want):
    """A one-epoch metric's rtol: DRIFT, or SPREAD x the JAX package's own
    gap there (``epoch_witness``) where that is wider."""
    return max(DRIFT, SPREAD * abs(witness - want) / abs(want))


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
