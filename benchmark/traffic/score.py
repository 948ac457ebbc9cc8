"""Forward-only scoring of a fixed library through ``loop.evaluate`` over
a ``loop.DeviceCacheLoader`` (the Trainer's eval path), filled during
set-up; each pass of the window is one ``evaluate`` call over the cached
batches, passes back to back until the window's seconds have passed.  A
forward hook keeps each step's predictions, and every molecule of every
pass is compared with the reference's prediction of it."""
from __future__ import annotations

from typing import List

import torch

from .. import compare, drive
from ..reference import for_model
from ..reference import prep as ref_prep

WARMUP_PASSES = 2
PROFILE_STEPS = 8
CALIBRATE = 128


def window(ctx: drive.Cell) -> dict:
    from kpgnn_tpu_torch.train import loop
    from kpgnn_tpu_torch.train.loader import GraphLoader

    model = ctx.model
    loader = GraphLoader(ctx.graphs, ctx.tr["batch_size"], shuffle=False,
                         **ctx.loader_kw)
    cache = loop.DeviceCacheLoader(loader, ctx.device)
    preds: List[torch.Tensor] = []
    model.register_forward_hook(lambda mod, i, o: preds.append(o))

    def one_pass(feed, step):
        return loop.evaluate(model, feed, ctx.cfg["train"]["loss"],
                             ctx.cfg["eval_metric"], step=step)
    for _ in range(WARMUP_PASSES):
        one_pass(ctx.feed(iter(cache)), loop.eval_step)
    if cache._cache is None:
        raise RuntimeError("the library's batches overflow the "
                           "DeviceCacheLoader's cap: every pass would "
                           "collate again")
    if ctx.trace:               # the profiler's own first use, unmeasured
        with torch.profiler.profile():
            one_pass(ctx.feed(iter(cache)), loop.eval_step)
    preds.clear()
    ctx.open_window()
    step = drive.timed(lambda *a: loop.eval_step(*a), ctx.rec)
    while ctx.in_window():
        one_pass(ctx.window_feed(iter(cache), deadline=False), step)
    ctx.close_window(train=False)
    return dict(preds=preds, steps=ctx.molecules(ctx.window_feeds))


def _reference(cfg, raw, P0, device):
    m = cfg["model"]
    preps = ref_prep.prep_all(raw, drive.ref_prep_config(m))
    return drive.ref_forward_all(for_model(m["model_name"]), P0, raw, preps,
                                 m, device)


def check(cfg, tr, raw, P0, got, device):
    return compare.score_numbers(got["preds"], got["steps"],
                                 _reference(cfg, raw, P0, device))


def control(cfg, tr, seed, device):
    """The reference with TF32 matmuls against the reference in full
    f32, over the whole library."""
    raw, P0 = drive.inputs(cfg, tr, seed, device)
    out = {}
    for tf32 in (False, True):
        drive.set_tf32(tf32)
        out[tf32] = _reference(cfg, raw, P0, device)
    drive.set_tf32(False)
    return {"pred_gap": compare.pred_gap(out[True][None], out[False])[0]}
