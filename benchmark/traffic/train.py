"""Closed-loop training.  Set-up builds the program's optimizer, a
shuffled ``GraphLoader`` over the prepped library (collating in its
thread, every epoch reshuffled) behind ``loop.device_prefetch``, and
drives the first ``CHECK_STEPS`` steps through ``loop.train_epoch`` with
the window's own step, keeping the first gradient (from Adam's state)
and the parameters after the last of them; then ``WARMUP_STEPS`` more.
The window continues the same stream with one more ``train_epoch`` call
until its seconds have passed.  The reference follows the check steps
on the molecules their batches held."""
from __future__ import annotations

import itertools
from typing import Dict, List

import torch

from .. import compare, drive, molecules
from ..reference import common as ref_common
from ..reference import for_model
from ..reference import prep as ref_prep

CHECK_STEPS = 3
WARMUP_STEPS = 4
PROFILE_STEPS = 6


def window(ctx: drive.Cell) -> dict:
    from kpgnn_tpu_torch.train import loop
    from kpgnn_tpu_torch.train.loader import GraphLoader
    from kpgnn_tpu_torch.train.state import make_optimizer

    t, model = ctx.cfg["train"], ctx.model
    loader_seed = int(molecules.rng_for(ctx.seed, 1).integers(1 << 31))
    loader = GraphLoader(ctx.graphs, ctx.tr["batch_size"], shuffle=True,
                         seed=loader_seed, **ctx.loader_kw)
    opt = make_optimizer(model.parameters(), t["lr"], t["l2_wd"])
    gen = torch.Generator(device=ctx.device).manual_seed(0)
    names = [n for n, _ in model.named_parameters()]

    def epochs():
        while True:
            yield from loader
    stream = loop.device_prefetch(epochs(), ctx.device)
    kept: Dict[str, dict] = {}
    taken = []

    def check_step(model_, opt_, batch, *a):
        out = loop.train_step(model_, opt_, batch, *a)
        taken.append(1)
        if len(taken) == 1:
            b1 = opt_.param_groups[0]["betas"][0]
            kept["grad"] = {
                n: (opt_.state[p]["exp_avg"].detach().clone() / (1 - b1)
                    if "exp_avg" in opt_.state.get(p, {})
                    else torch.zeros_like(p))
                for n, p in zip(names, model_.parameters())}
        if len(taken) == CHECK_STEPS:
            kept["params"] = {n: p.detach().clone() for n, p in
                              zip(names, model_.parameters())}
        return out

    pred1: List[torch.Tensor] = []
    hook = model.register_forward_hook(
        lambda mod, i, o: pred1.append(o.detach().clone())
        if not pred1 else None)
    check_feed = ctx.feed(itertools.islice(stream, CHECK_STEPS))
    _, losses = loop.train_epoch(model, opt, check_feed, t["loss"], gen,
                                 step=check_step)
    hook.remove()
    loop.train_epoch(model, opt,
                     ctx.feed(itertools.islice(stream, WARMUP_STEPS)),
                     t["loss"], gen)
    if ctx.trace:               # the profiler's own first use, unmeasured
        with torch.profiler.profile():
            loop.train_epoch(model, opt,
                             ctx.feed(itertools.islice(stream, 1)),
                             t["loss"], gen)
    ctx.open_window()
    loop.train_epoch(model, opt, ctx.window_feed(stream), t["loss"], gen,
                     step=drive.timed(lambda *a: loop.train_step(*a),
                                      ctx.rec))
    ctx.close_window(train=True)
    stream.close()
    steps = ctx.molecules([check_feed])
    p1 = pred1[0] if pred1 else torch.zeros(0)
    if steps and p1.numel():
        p1 = p1.reshape(p1.shape[0], -1)[:, 0][
            torch.as_tensor(steps[0][0], device=p1.device)]
    return dict(losses=list(losses), kept=kept, pred1=p1,
                batches=[ids for _, ids in steps])


def _reference(cfg, raw, P0, idx, device):
    m = cfg["model"]
    pc = drive.ref_prep_config(m)
    flat = sorted({int(i) for ix in idx for i in ix})
    preps = dict(zip(flat, ref_prep.prep_all([raw[i] for i in flat], pc)))
    batches = [ref_common.make_batch([raw[i] for i in ix],
                                     [preps[int(i)] for i in ix], device)
               for ix in idx]
    return ref_common.adam_steps(for_model(m["model_name"]), P0, batches,
                                 m, cfg["train"])


def check(cfg, tr, raw, P0, got, device):
    idx = got["batches"]
    if len(idx) != CHECK_STEPS or any(len(ix) == 0 or (ix < 0).any()
                                      for ix in idx):
        return compare.train_failed(
            f"{len(idx)} check batches, of "
            f"{[int((ix >= 0).sum()) for ix in idx]} known molecules")
    losses, g1, p3, r_pred1 = _reference(cfg, raw, P0, idx, device)
    kept = got["kept"]
    return compare.train_numbers(got["losses"], kept["grad"],
                                 kept["params"], got["pred1"], losses, g1,
                                 p3, r_pred1, P0)


def control(cfg, tr, seed, device):
    """The reference with TF32 matmuls against the reference in full
    f32, over ``CHECK_STEPS`` batches of the library drawn from the
    seed."""
    raw, P0 = drive.inputs(cfg, tr, seed, device)
    order = molecules.rng_for(seed, 2).permutation(len(raw))
    bs = tr["batch_size"]
    idx = [order[i * bs:(i + 1) * bs] for i in range(CHECK_STEPS)]
    drive.set_tf32(False)
    ref = _reference(cfg, raw, P0, idx, device)
    drive.set_tf32(True)
    ctl = _reference(cfg, raw, P0, idx, device)
    drive.set_tf32(False)
    return compare.train_numbers(*ctl[:4], *ref[:4], P0)[0]
