"""The 95th percentile of the times between consecutive step boundaries
(CUDA events recorded on the compute stream as the loop takes each next
batch, and one after the last step), over every step of the window."""
import numpy as np


def read(rec):
    return float(np.percentile(rec.step_ms, 95)) if rec.step_ms else None
