"""Per-module activation dumps for cross-framework parity checks
(counterpart of kpgnn_tpu/utils/parity.py).

``capture_activations`` runs one eval forward with a forward hook on
every module and returns each module's output as a numpy array, keyed as
the JAX package keys its flax intermediates: the module path with ``/``
separators, then ``__call__`` (``embedding_model/gnn0/__call__``; the
model itself is ``__call__``).  A module that returns a tuple (an LSTM)
is keyed by its first element; outputs that are not tensors are skipped.
``dump_activations`` writes them to an ``.npz``.

``jax_layout=True`` gives the JAX capture's layout, what a golden bundle
stores: a ``BiLSTM`` called time-major (the hop-major combine's attention
LSTM, (K, N, 2H)) is transposed back to the JAX module's node-major
(N, K, 2H), and no module inside a ``BiLSTM`` (the ``torch.nn.LSTM``
holding its weights) is captured.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _key(name: str) -> str:
    return "/".join(name.split(".") + ["__call__"]) if name else "__call__"


@torch.no_grad()
def capture_activations(model: torch.nn.Module, batch,
                        jax_layout: bool = False) -> Dict[str, np.ndarray]:
    from ..ops.lstm import BiLSTM       # ops imports utils.profiling

    out: Dict[str, np.ndarray] = {}

    def hook(name):
        def record(module, args, kwargs, output):
            if isinstance(output, (tuple, list)) and output:
                output = output[0]
            if not torch.is_tensor(output):
                return
            if (jax_layout and isinstance(module, BiLSTM)
                    and kwargs.get("time_major", False)):
                output = output.transpose(0, 1)
            out[_key(name)] = output.detach().float().cpu().numpy()
        return record

    lstms = [n for n, m in model.named_modules() if isinstance(m, BiLSTM)]
    handles = [m.register_forward_hook(hook(n), with_kwargs=True)
               for n, m in model.named_modules()
               if not (jax_layout and any(n.startswith(p + ".")
                                          for p in lstms))]
    try:
        model(batch, train=False)
    finally:
        for h in handles:
            h.remove()
    return out


def dump_activations(model: torch.nn.Module, batch, path: str
                     ) -> Dict[str, tuple]:
    acts = capture_activations(model, batch)
    np.savez_compressed(path, **acts)
    return {k: v.shape for k, v in acts.items()}
