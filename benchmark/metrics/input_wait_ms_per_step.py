"""Mean host milliseconds a step waits in ``next()`` on the batch
iterable the loop consumes."""


def read(rec):
    return 1e3 * sum(rec.wait_s) / len(rec.wait_s) if rec.wait_s else None
