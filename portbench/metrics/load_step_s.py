"""The window's whole wall time over the load steps that converged in it."""


def read(rec):
    w = rec.timed
    return w.seconds / w.counts["converged"] if w.counts["converged"] else None
