"""Gauss-point updates a second: every point of every increment over the
window's whole wall time."""


def read(rec):
    w = rec.timed
    return w.counts["point_updates"] / w.seconds if w.seconds > 0 else None
