"""100 x (1 - the union of the device's event intervals over the
profiled span), in percent."""


def read(rec):
    t = rec.trace
    if t is None or t.span_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.span_s)
