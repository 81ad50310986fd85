"""The Ogden update's least time (``hyperelastic_work``: the mesh's points'
F read, PK1 and tangent written, at the data sheet's HBM rate) over the
device's busy time inside the harness span ``constitutive`` (each update
and flux call of the profiled window, between two synchronisations), in
%."""

from portbench import hyperelastic_work


def read(rec):
    w = rec.traced
    busy = w.trace.host_clipped.get("constitutive") if w and w.trace else None
    if not busy:
        return None
    return 100.0 * hyperelastic_work.least_seconds(w.counts, rec.shapes["n_points"]) / busy
