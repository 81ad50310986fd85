"""CG iterations a load step (the step's own count, warm-up and polish
together), over the instrumented window."""


def read(rec):
    w = rec.timed
    return w.counts["cg"] / w.counts["attempted"] if w.counts["attempted"] else None
