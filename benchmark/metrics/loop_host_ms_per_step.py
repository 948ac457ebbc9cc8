"""Mean host milliseconds of each step call (``loop.train_step`` or
``loop.eval_step`` as ``train_epoch`` or ``evaluate`` calls it)."""


def read(rec):
    return 1e3 * sum(rec.host_s) / len(rec.host_s) if rec.host_s else None
