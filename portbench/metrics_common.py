"""Arithmetic that several metric readers share."""


def idle_pct(rec):
    """100 less the device's busy share of the profiled window, in %: busy
    is the union of the device operations' intervals."""
    t = rec.traced.trace if rec.traced else None
    if t is None or t.window_s <= 0 or t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
