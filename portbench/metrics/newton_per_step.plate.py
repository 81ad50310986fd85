"""Newton iterations a load step (the step's own count), over the
instrumented window."""


def read(rec):
    w = rec.timed
    return w.counts["newton"] / w.counts["attempted"] if w.counts["attempted"] else None
