"""Wall ms a CG iteration: the CG solves timed between two
synchronisations of the card, over the iterations they ran (the
instrumented window, not profiled)."""


def read(rec):
    w = rec.timed
    return 1e3 * sum(w.spans["cg_solve"]) / w.counts["cg"] if w.counts["cg"] else None
