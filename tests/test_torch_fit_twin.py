"""Whole runs of the port's ``Trainer.fit`` against the JAX package's, on
the CPU: the same carried initial weights (the JAX ``create_train_state``
init through ``utils/convert.params_from_flax``, loaded in place of the
port's ``init_parameters``), the same shuffle seed, dropout 0, per-batch
epochs on both sides, and a patience of 1 so the plateau schedule halves
the learning rate within the run.

Cases: the flagship's shape at small width (``FLAGSHIP_SMALL``) on the COO
backend and on the kernel plan (``pallas``; on the JAX side the kernel's
plain reference, ``pallas_spmm._gather_reference``, which the JAX package
itself runs where interpret mode cannot, and which its own tests hold the
kernel to; interpret mode would take the file past its time budget).
tests/test_torch_fit_twin_qm9.py runs the same checks on a small QM9
model.

Each case runs the JAX Trainer once and the port's twice.

* The free run (the port's Trainer alone from the carried init): the
  learning rate of every epoch (as the f32 the JAX optimizer stores) and
  the best epoch, exactly.
* The resynchronized run: the same Trainer, whose epoch hook loads the
  JAX run's weights, running statistics and Adam moments of the end of
  each epoch but the last.  Each epoch then starts where the JAX run's
  did; the learning rate and the best epoch hold exactly, and every step
  loss and ``train_loss`` at rtol max(1e-5, 2x the JAX package's own gap
  there).  That gap is the witness (``jax_witness``): the JAX run's
  epoch again, from the same start with every weight one ulp up.  Why
  not the free run at 1e-5: the two packages round their sums in other
  orders, and Adam scales the gradients that rounding dominates (the
  biases ahead of batch norms, whose exact gradient is 0, and sums that
  cancel, as a batch norm's scale) to steps of about lr.  At this size
  that drift carries the step losses of the free runs 1e-5 to 4e-2 apart
  within 18 steps, as far as the JAX package's own COO and dense runs
  part from each other (1.6e-3 at step 10, from one init).  Within one
  epoch from a shared start the drift is mostly under rounding: here
  the port's step gaps are at most 5.5e-6 (epochs 2.7e-6) and the
  witness's 2.6e-6, so the tolerance is 1e-5 at every step (1.8x the
  largest gap).  Where an epoch's steps turn one ulp into more, the
  witness parts as far as the port: tests/test_torch_fit_twin_qm9.py's
  kernel-plan case, 1.6e-4 and 2.6e-4 at two steps on both sides.

Then:

* the port's evaluation of the JAX run's final weights equals the JAX
  run's last validation metrics and the JAX evaluation of those weights
  on the test split, at rtol 1e-5 (the same weights; f32 sums in another
  order);
* after the resynchronized run's last epoch, the leaves further than 1e-4
  from the JAX run's are only those whose exact gradient is 0 (the biases
  ahead of a batch norm, an MLP's ``lin0``/``lin1``, which the batch
  statistics cancel, and the attention pooling gate's bias, to which the
  per-graph softmax is blind: rounding picks their gradient's sign and
  Adam moves them by about lr either way) and the batch norms' running
  statistics, which follow the first.
"""
import jax
import numpy as np
import pytest
import torch

import kpgnn_tpu.models as jmodels
import kpgnn_tpu.ops.pallas_spmm as jpallas
import kpgnn_tpu.train.loop as jloop
from kpgnn_tpu.train.config import TrainConfig as JTrainConfig
from kpgnn_tpu.train.loader import GraphLoader as JGraphLoader
from kpgnn_tpu_torch.models.factory import ModelConfig, make_model
from kpgnn_tpu_torch.train import loop as tloop
from kpgnn_tpu_torch.train.config import TrainConfig
from kpgnn_tpu_torch.train.loader import GraphLoader
from kpgnn_tpu_torch.utils.convert import params_from_flax
from tests.test_torch_layers import flat
from tests.test_torch_model import FLAGSHIP_SMALL, PREP_SMALL
from tests.test_torch_prep_batch import both_prep, raw_molecules

torch.set_num_threads(1)
RTOL = 1e-5
SPREAD = 2.0
APART = 1e-4


def zero_gradient_or_stat(name: str) -> bool:
    """A leaf whose exact gradient is 0 (a bias that feeds a batch norm, an
    MLP's ``lin0``/``lin1``, whose outputs each pass one; the attention
    pooling gate's bias, to which the per-graph softmax is blind) or a
    batch norm's running statistic."""
    return name.endswith(("lin0.bias", "lin1.bias", "pool_gate.bias",
                          "running_mean", "running_var"))


def port_state(variables) -> dict:
    """The port's state_dict of flax variables."""
    return params_from_flax(flat(jax.device_get(variables)))


def adam_moments(opt_state):
    """(step count, mu, nu) of the JAX optimizer's Adam state, the moments
    as the port's parameter names."""
    adam = next(s for s in opt_state.inner_state if hasattr(s, "mu"))
    return (int(adam.count), port_state({"params": adam.mu}),
            port_state({"params": adam.nu}))


def load_jax_state(model, opt, state) -> None:
    """The JAX TrainState's weights, running statistics and Adam moments
    into the port's model and torch Adam (learning rate untouched)."""
    model.load_state_dict(port_state(state.variables), strict=True)
    count, mu, nu = adam_moments(jax.device_get(state.opt_state))
    for name, p in model.named_parameters():
        opt.state[p] = {"step": torch.tensor(float(count)),
                        "exp_avg": mu[name].clone(),
                        "exp_avg_sq": nu[name].clone()}


def loaders(cls, splits, mode, cfg, batch_size, seed):
    kw = ({} if mode == "coo" else
          dict(v1=cfg["num_hop1_edge"] + 2, vk=cfg["max_pe_num"] + 2))
    train, val, test = splits
    return (cls(train, batch_size, shuffle=True, seed=seed, mode=mode, **kw),
            cls(val, batch_size, mode=mode, **kw),
            cls(test, batch_size, mode=mode, **kw))


def train_config(cls, epochs, bs):
    return cls(lr=1e-3, num_epochs=epochs, batch_size=bs, patience=1)


def jax_fit(monkeypatch, cfg, splits, mode, loss, metric, epochs, bs,
            seed):
    """The JAX Trainer's run: (results, init variables, step losses,
    TrainState at the end of each epoch, its test loader, witness).  The
    witness is ``jax_witness`` of the run."""
    steps, init, states, replay = [], {}, [], []
    make_step, make_state = jloop.make_train_step, jloop.create_train_state

    def recording_step(*a, **k):
        step = make_step(*a, **k)
        init["step"] = step

        def run(state, batch, rng):
            replay.append((batch, rng))
            state, m = step(state, batch, rng)
            steps.append(float(m["loss_sum"]) / float(m["count"]))
            return state, m
        return run

    def recording_state(*a, **k):
        state, tx = make_state(*a, **k)
        init["state"] = jax.device_get(state)
        return state, tx

    monkeypatch.setattr(jloop, "make_train_step", recording_step)
    monkeypatch.setattr(jloop, "create_train_state", recording_state)
    monkeypatch.setattr(jpallas, "gather_segment_sum",
                        lambda x, csr, **kw: jpallas._gather_reference(x, csr))
    tl, vl, el = loaders(JGraphLoader, splits, mode, cfg, bs, seed)
    trainer = jloop.Trainer(
        jmodels.make_model(jmodels.ModelConfig(**cfg)),
        train_config(JTrainConfig, epochs, bs), loss=loss,
        eval_metric=metric, resident="off")
    _, res = trainer.fit(
        tl, vl, el, rng=jax.random.PRNGKey(seed),
        epoch_callback=lambda e, s, row: states.append(jax.device_get(s)))
    witness = jax_witness(init["step"], [init["state"]] + states[:-1],
                          replay)
    return res, init["state"].variables, steps, states, el, witness


def one_ulp_up(state):
    """``state`` with every weight moved one ulp towards +inf."""
    return state.replace(params=jax.tree_util.tree_map(
        lambda p: np.nextafter(p, np.inf, dtype=p.dtype), state.params))


def jax_witness(step, starts, replay):
    """The JAX package against itself: each epoch of its run again, from
    that epoch's start (``starts``: the init, then each epoch's end) with
    every weight one ulp up, through the same jitted step on the same
    batches.  Returns (step losses, per-epoch train losses)."""
    n_steps = len(replay) // len(starts)
    steps, epochs = [], []
    for e, state in enumerate(starts):
        state, sums, counts = one_ulp_up(state), [], []
        for batch, rng in replay[e * n_steps:(e + 1) * n_steps]:
            state, m = step(state, batch, rng)
            sums.append(float(m["loss_sum"]))
            counts.append(float(m["count"]))
            steps.append(sums[-1] / counts[-1])
        epochs.append(sum(sums) / max(sum(counts), 1.0))
    return np.array(steps), np.array(epochs)


def assert_within_spread(got, want, witness, what):
    """``got`` within ``want``'s rtol of max(RTOL, SPREAD x the witness's
    own gap from ``want``), element by element."""
    got, want, witness = (np.atleast_1d(np.asarray(v, np.float64))
                          for v in (got, want, witness))
    tol = np.maximum(RTOL, SPREAD * np.abs(witness - want) / np.abs(want))
    gap = np.abs(got - want) / np.abs(want)
    assert (gap <= tol).all(), f"{what}: gaps {gap} over {tol}"


def port_fit(monkeypatch, cfg, splits, mode, loss, metric, epochs, bs, seed,
             variables, resync=None):
    """The port's run from the JAX init: (model, results, val loader, test
    loader).  With ``resync`` (the JAX run's TrainState of each epoch's
    end), every epoch but the last ends by loading the JAX run's state."""
    carried = port_state(variables)
    opts = []

    def carried_init(model, seed):
        model.load_state_dict(carried, strict=True)
        return model

    def recording_optimizer(*a, **k):
        opts.append(make_optimizer(*a, **k))
        return opts[-1]

    def resync_epoch(epoch, model, row):
        if resync is not None and epoch < epochs - 1:
            load_jax_state(model, opts[-1], resync[epoch])

    make_optimizer = tloop.make_optimizer
    monkeypatch.setattr(tloop, "init_parameters", carried_init)
    monkeypatch.setattr(tloop, "make_optimizer", recording_optimizer)
    tl, vl, el = loaders(GraphLoader, splits, mode, cfg, bs, seed)
    trainer = tloop.Trainer(
        make_model(ModelConfig(**cfg)), train_config(TrainConfig, epochs, bs),
        loss=loss, eval_metric=metric, device="cpu", resident="off")
    model, res = trainer.fit(tl, vl, el, seed=seed,
                             epoch_callback=resync_epoch)
    monkeypatch.setattr(tloop, "make_optimizer", make_optimizer)
    return model, res, vl, el


def eval_keys(row, split):
    return {k[len(split) + 1:]: v for k, v in row.items()
            if k.startswith(split + "_") and k != f"{split}_count"}


def lrs(history):
    return [np.float32(r["lr"]) for r in history]


def assert_twin_runs(monkeypatch, cfg, jsplits, tsplits, mode, loss, metric,
                     epochs, bs=8, seed=3):
    """The three runs, each package on its own prep of the same graphs
    (tests/test_torch_prep_batch.py holds the two preps bit-equal), and
    the checks of the module docstring.  Returns the JAX history."""
    jres, variables, jsteps, jstates, jel, (wsteps, wepochs) = jax_fit(
        monkeypatch, cfg, jsplits, mode, loss, metric, epochs, bs, seed)
    jh = jres["history"]
    assert len(jh) == len(jstates) == epochs
    assert len(set(lrs(jh))) > 1, "the plateau schedule never fired"

    _, free, _, _ = port_fit(monkeypatch, cfg, tsplits, mode, loss, metric,
                             epochs, bs, seed, variables)
    assert lrs(free["history"]) == lrs(jh)
    assert free["best_epoch"] == jres["best_epoch"]

    model, tres, tvl, tel = port_fit(monkeypatch, cfg, tsplits, mode, loss,
                                     metric, epochs, bs, seed, variables,
                                     resync=jstates)
    th = tres["history"]
    n_steps = -(-len(tsplits[0]) // bs)
    assert len(th) == epochs and len(jsteps) == n_steps * epochs
    for e, (a, b) in enumerate(zip(jh, th)):
        cut = slice(e * n_steps, (e + 1) * n_steps)
        assert_within_spread(b["step_losses"], jsteps[cut], wsteps[cut],
                             f"epoch {e} step losses")
        assert_within_spread(b["train_loss"], a["train_loss"], wepochs[e],
                             f"epoch {e} train loss")
    assert lrs(th) == lrs(jh)
    assert tres["best_epoch"] == jres["best_epoch"]

    # the port's evaluation of the JAX run's final weights
    final = port_state(jstates[-1].variables)
    twin = make_model(ModelConfig(**cfg))
    twin.load_state_dict(final, strict=True)
    jtest = jloop.evaluate(
        jloop.make_eval_step(jmodels.make_model(jmodels.ModelConfig(**cfg)),
                             loss, metric=metric), jstates[-1], jel)
    for loader, want in ((tvl, eval_keys(jh[-1], "val")),
                         (tel, {k: v for k, v in jtest.items()
                                if k != "count"})):
        got = tloop.evaluate(twin, list(loader), loss, metric)
        assert want
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, err_msg=k)

    # only pre-BN biases and running statistics part beyond 1e-4
    state = model.state_dict()
    assert sorted(state) == sorted(final)
    far = sorted((float((state[n].double() - final[n].double()).abs().max()),
                  n) for n in state if state[n].is_floating_point())
    far = [(d, n) for d, n in far if d > APART]
    assert all(zero_gradient_or_stat(n) for _, n in far), far
    return jh


def zinc_splits():
    js, ts = both_prep(raw_molecules(40, seed=5), **PREP_SMALL)
    cut = lambda g: (g[:24], g[24:32], g[32:])
    return cut(js), cut(ts)


@pytest.mark.parametrize("mode", ["coo", "pallas"])
def test_flagship_small_fit_equals_jax(monkeypatch, mode):
    js, ts = zinc_splits()
    jh = assert_twin_runs(monkeypatch, dict(FLAGSHIP_SMALL), js, ts, mode,
                          "l1", "same", epochs=6, seed=0)
    assert jh[-1]["train_loss"] < jh[0]["train_loss"]
