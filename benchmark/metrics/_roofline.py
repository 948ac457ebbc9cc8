"""A kernel family's share of its roofline over the profiled steps: the
summed least times of its launches (``counts/bounds.py``, from each
launch's own shapes and indices) over their summed device time."""


def share(rec, family):
    t = rec.trace
    if t is None or not t.event_n[family] \
            or t.event_n[family] != t.bound_n[family]:
        return None
    return 100.0 * t.bound_ms[family] / (1e3 * t.kernel_s[family])
