"""Kernel launches per profiled step, from the profiler's trace."""


def read(rec):
    t = rec.trace
    return t.kernels / t.steps if t is not None and t.steps else None
