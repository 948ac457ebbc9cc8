"""Carry weights between the port and the JAX package.

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

``params_to_flax`` is its inverse: a state_dict (torch tensors) in, the
flattened flax variables (numpy) out, bit for bit.  A 2-D ``weight`` is
a Dense kernel or an embedding table, which the tensors alone cannot
tell apart, so the caller names the embedding modules
(``embedding_modules(model)``).
"""
from __future__ import annotations

from typing import Dict, Iterable, Mapping

import numpy as np
import torch

from ..nn.embed import PaddedEmbed

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


LSTM_LEAVES = {v: k for k, v in LSTM_TENSORS.items()}
STAT_NAMES = {v: k for k, v in STAT_LEAVES.items()}


def embedding_modules(model: torch.nn.Module) -> Iterable[str]:
    """Dotted paths of ``model``'s embedding tables (flax ``nn.Embed``)."""
    return [n for n, m in model.named_modules() if isinstance(m, PaddedEmbed)]


def params_to_flax(state_dict: Mapping[str, torch.Tensor],
                   embeddings: Iterable[str]) -> Dict[str, np.ndarray]:
    """The port's state_dict -> flattened flax variables (``params/a/b/
    leaf``, ``batch_stats/...``), the inverse of ``params_from_flax``:
    ``weight`` becomes a Dense ``kernel`` (transposed back to (in, out)),
    an ``embedding`` (modules in ``embeddings``) or a norm's ``scale``
    (1-D); ``running_mean``/``running_var`` go to ``batch_stats``;
    the ``torch.nn.LSTM`` tensors take the BiLSTM's gate names."""
    embeddings = set(embeddings)
    flat: Dict[str, np.ndarray] = {}
    for key, value in state_dict.items():
        *path, name = key.split(".")
        arr = value.detach().cpu().numpy()
        coll = "params"
        if name in STAT_NAMES:
            coll, leaf = "batch_stats", STAT_NAMES[name]
        elif path and path[-1] == "lstm" and f"lstm.{name}" in LSTM_LEAVES:
            path, leaf = path[:-1], LSTM_LEAVES[f"lstm.{name}"]
        elif name == "weight" and ".".join(path) in embeddings:
            leaf = "embedding"
        elif name == "weight" and arr.ndim == 2:
            leaf, arr = "kernel", np.ascontiguousarray(arr.T)
        elif name == "weight":
            leaf = "scale"
        else:
            leaf = name
        flat["/".join([coll, *path, leaf])] = arr
    return flat
