"""Exponential moving average of parameters (counterpart of
kpgnn_tpu/train/ema.py; reference: train_utils.py:44-91)."""
from __future__ import annotations

from typing import Dict, Mapping

import torch


class EMA:
    """``shadow`` = decay * shadow + (1 - decay) * params, over a name ->
    tensor mapping (``dict(model.named_parameters())``), on the
    parameters' device."""

    def __init__(self, params: Mapping[str, torch.Tensor],
                 decay: float = 0.999):
        self.decay = decay
        with torch.no_grad():
            self.shadow: Dict[str, torch.Tensor] = {
                k: v.detach().clone() for k, v in params.items()}

    def update(self, params: Mapping[str, torch.Tensor]
               ) -> Dict[str, torch.Tensor]:
        d = self.decay
        with torch.no_grad():
            self.shadow = {k: d * self.shadow[k] + (1.0 - d) * v.detach()
                           for k, v in params.items()}
        return self.shadow
