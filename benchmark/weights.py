"""Seeded weights for both sides: one ``torch.rand`` call on the device
for every tensor of ``reference.model.param_spec``, then a scale per
tensor by its rule."""
from __future__ import annotations

from typing import Dict

import torch


def make_weights(spec, seed: int, device) -> Dict[str, torch.Tensor]:
    total = sum(int(torch.Size(shape).numel()) for shape, _ in spec.values())
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    flat = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, off = {}, 0
    for name, (shape, (rule, scale)) in spec.items():
        n = int(torch.Size(shape).numel())
        u = flat[off:off + n].view(shape)
        off += n
        out[name] = (1.0 + scale * u) if rule == "around_one" else scale * u
    return out
