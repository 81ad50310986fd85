"""The CG iterations' least time (``roofline.cg_iteration_bytes`` at the
data sheet's HBM rate: bytes-bound) over the device's busy time inside the
CG solves (profiled window; the solves are bracketed by synchronisations),
in %."""

from portbench import roofline


def read(rec):
    w = rec.traced
    busy = w.trace.host_clipped.get("cg_solve") if w.trace else None
    if not busy or not w.counts["cg"]:
        return None
    s = rec.shapes
    least = w.counts["cg"] * roofline.least_seconds(roofline.cg_iteration_bytes(**s), 0, s["dtype"])
    return 100.0 * least / busy
