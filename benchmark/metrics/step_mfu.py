"""Model FLOPs of the window's steps on their real nodes and edges
(``counts/flops.py``) over the window's time and the card's f32 peak,
in percent."""
from ..counts.peaks import F32_FLOPS


def read(rec):
    if rec.window_s <= 0 or rec.flops <= 0:
        return None
    return 100.0 * rec.flops / rec.window_s / F32_FLOPS
