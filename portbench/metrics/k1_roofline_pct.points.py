"""The updates' least time (``roofline.j2_update_bytes`` at the data
sheet's HBM rate, or the operations at its f64 rate where longer) over the
device time of what the update calls launched (from the first to the last
device operation of each call, Kineto's GPU annotation), in %."""

from portbench import laws, roofline


def read(rec):
    w = rec.traced
    busy = w.trace.device_clipped.get("update") if w.trace else None
    if not busy:
        return None
    s = rec.shapes
    n, dtype = s["n_points"], s["dtype"]
    h_ops = 10 if s["law"] is None else 3 * laws.operation_count(s["law"])
    per = roofline.least_seconds(roofline.j2_update_bytes(n, dtype), roofline.j2_update_ops(n, hardening_ops=h_ops), dtype)
    return 100.0 * per * len(w.spans["increment"]) / busy
