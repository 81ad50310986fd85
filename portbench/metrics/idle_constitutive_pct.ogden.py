"""The device's idle while the Ogden update's host path runs, in % of the
profiled window: the length of the program's ``hyperelastic: constitutive
update`` and ``hyperelastic: flux`` spans less the device's busy time inside
them (``drivers/ogden_protocol.py`` ``idle_in_scopes``), the gaps of the
operators and runtime calls inside them included."""


def read(rec):
    w = rec.traced
    idle = getattr(w, "idle_in_scopes", None) if w else None
    return 100.0 * idle / w.trace.window_s if idle is not None and w.trace and w.trace.window_s > 0 else None
