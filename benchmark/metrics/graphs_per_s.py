"""Real molecules completed in the window (trained or scored) over the
window's wall time, its final synchronise included."""


def read(rec):
    return rec.graphs / rec.window_s if rec.window_s > 0 else None
