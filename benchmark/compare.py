"""The numbers that decide ``correct``: what the program produced on the
timed path against the reference's run over the same inputs.

Training (the first steps of the run, taken through the window's own
step and feed):
* ``loss_gap``: the largest |program loss - reference loss| / |reference
  loss| over the steps; ``loss1_gap`` the first step's alone;
* ``pred1_gap``: the first step's predictions, as ``pred_gap`` below;
* ``grad_gap``: over the parameters, the largest gap between the norm of
  the program's first gradient (Adam's first moment after step 1, over
  1 - beta1) and the reference's, over the reference's norm of that
  parameter or the median parameter's, whichever is larger;
  ``grad_median_gap`` the median parameter's gap;
* ``update_gap``: the same of the parameters' change over the steps,
  leaving out parameters whose reference gradient is under a thousandth
  of the median parameter's (they move under Adam by rounding alone);
  ``update_median_gap`` the median parameter's.
A cell's limits file names the numbers it compares.

Scoring: ``pred_gap``, the largest |program prediction - reference| over
every molecule of every step of the window, over the root mean square
of the reference's predictions of the library.

Both: ``molecules_short`` (``drive.Cell.shortfall``), the molecules that
the run's batches left out of what the loader promises.
"""
from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch


def _norms(d: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            d.items()}


def _gaps(prog: Dict[str, float], ref: Dict[str, float], keys):
    """{leaf: |prog norm - ref norm| over the larger of the leaf's ref
    norm and the median leaf's}."""
    med = float(np.median([ref[k] for k in keys]))
    return {k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
            for k in keys}


TRAIN_NUMBERS = ("loss_gap", "loss1_gap", "pred1_gap", "grad_gap",
                 "grad_median_gap", "update_gap", "update_median_gap")


def train_failed(why: str):
    """Every training number at infinity, and why."""
    return {k: math.inf for k in TRAIN_NUMBERS}, why


def train_numbers(p_losses: Sequence[float], p_grad, p_params, p_pred1,
                  r_losses: Sequence[float], r_grad, r_params, r_pred1, P0):
    """(numbers, a line naming the worst parameters)."""
    if len(p_losses) != len(r_losses) or p_pred1.shape != r_pred1.shape:
        return train_failed("steps missing")
    rel = [float(abs(a - b) / abs(b)) for a, b in zip(p_losses, r_losses)]
    names = list(r_grad)
    gn_ref = _norms(r_grad)
    g = _gaps(_norms({k: p_grad[k] for k in names}), gn_ref, names)
    med = float(np.median(list(gn_ref.values())))
    moved = [k for k in names if gn_ref[k] >= 1e-3 * med]
    u = _gaps(_norms({k: p_params[k] - P0[k] for k in moved}),
              _norms({k: r_params[k] - P0[k] for k in moved}), moved)
    gw, uw = max(g, key=g.get), max(u, key=u.get)
    return ({"loss_gap": max(rel), "loss1_gap": rel[0],
             "pred1_gap": pred_gap(p_pred1[None], r_pred1)[0],
             "grad_gap": g[gw],
             "grad_median_gap": float(np.median(list(g.values()))),
             "update_gap": u[uw],
             "update_median_gap": float(np.median(list(u.values())))},
            f"step loss gaps {rel}, worst gradient {gw}, worst update "
            f"{uw}, {len(names) - len(moved)} of {len(names)} parameters "
            f"left out of the update")


def score_numbers(preds: List[torch.Tensor], steps, ref):
    """(numbers, a line) from the predictions of every step of the
    window: ``steps`` gives each step's graph mask and the molecule of
    each real graph, ``ref`` the reference's predictions of the
    library."""
    if not preds or len(preds) != len(steps):
        return {"pred_gap": math.inf}, (f"{len(preds)} step outputs for "
                                        f"{len(steps)} batches")
    got, idx = [], []
    for p, (mask, ids) in zip(preds, steps):
        if (ids < 0).any():
            return {"pred_gap": math.inf}, "a target names no molecule"
        p = p.reshape(p.shape[0], -1)[:, 0]
        got.append(p[torch.as_tensor(mask, device=p.device)].double())
        idx.append(ids)
    ref = ref.double()
    scale = float(torch.sqrt((ref ** 2).mean()))
    want = ref[torch.as_tensor(np.concatenate(idx), device=ref.device)]
    gap = float((torch.cat(got).to(ref.device) - want).abs().max()) \
        / max(scale, 1e-30)
    return {"pred_gap": gap}, (f"{len(steps)} steps, {want.shape[0]} "
                               f"predictions compared, reference rms "
                               f"{scale:.6g}")


def pred_gap(got: torch.Tensor, ref: torch.Tensor):
    """(the largest |got - ref| over ref's root mean square, that root
    mean square); ``got`` may hold several rows of ``ref``'s shape."""
    ref = ref.to(got.device).double()
    scale = float(torch.sqrt((ref ** 2).mean()))
    gap = float((got.double() - ref).abs().max()) / max(scale, 1e-30)
    return gap, scale
