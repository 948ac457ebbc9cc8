"""Carry weights over from the JAX package.

``params_from_flax`` takes the flattened ``params/...`` and
``batch_stats/...`` arrays that the golden bundles store
(kpgnn_tpu/scripts/make_parity_golden.py) — or that a test flattens from
live flax variables — and returns a state_dict for the port's model.  The
port names its modules after the flax module paths, so only the leaves
are renamed: a flax Dense ``kernel`` is stored (in, out) and becomes the
(out, in) ``weight``; ``embedding`` and BN ``scale`` become ``weight``;
BN ``mean``/``var`` become ``running_mean``/``running_var``; the BiLSTM's
gate matrices map onto ``torch.nn.LSTM``'s names (same (4H, F) layout and
i, f, g, o gate order).  Raw parameters (edge tables, gates, alphas) keep
their names.  numpy in, torch out: nothing here imports JAX.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

LSTM_TENSORS = {
    "w_ih_fwd": "lstm.weight_ih_l0", "w_hh_fwd": "lstm.weight_hh_l0",
    "b_ih_fwd": "lstm.bias_ih_l0", "b_hh_fwd": "lstm.bias_hh_l0",
    "w_ih_bwd": "lstm.weight_ih_l0_reverse",
    "w_hh_bwd": "lstm.weight_hh_l0_reverse",
    "b_ih_bwd": "lstm.bias_ih_l0_reverse",
    "b_hh_bwd": "lstm.bias_hh_l0_reverse",
}
PARAM_LEAVES = {"embedding": "weight", "scale": "weight", "bias": "bias"}
STAT_LEAVES = {"mean": "running_mean", "var": "running_var"}


def params_from_flax(flat: Mapping[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
    """Flattened flax variables (``params/a/b/leaf``, ``batch_stats/...``)
    -> the port's state_dict.  Other keys (activations, raw graphs) are
    ignored."""
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        coll, _, rest = key.partition("/")
        if coll not in ("params", "batch_stats"):
            continue
        *path, leaf = rest.split("/")
        arr = np.asarray(value)
        if coll == "batch_stats":
            name = STAT_LEAVES[leaf]
        elif leaf == "kernel":
            name, arr = "weight", arr.T
        elif leaf in LSTM_TENSORS:
            name = LSTM_TENSORS[leaf]
        else:
            name = PARAM_LEAVES.get(leaf, leaf)
        sd[".".join(path + [name])] = torch.tensor(arr)
    return sd
