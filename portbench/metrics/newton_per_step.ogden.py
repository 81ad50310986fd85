"""Newton iterations a load step (the step's own count, its float32
warm-up's and float64 polish's together), over the instrumented window."""


def read(rec):
    w = rec.timed
    return w.counts["newton"] / w.counts["attempted"] if w.counts["attempted"] else None
