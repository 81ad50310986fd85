"""The share of the CG iterations run in solves that reached their budget
(``n_cg``), in %: the program's counters ``cg: budget iterations`` over
``cg: iterations``, added while no profiler recorded (the warm-up step and
the instrumented window)."""

from portbench.program_registry import counters


def read(rec):
    c = counters()
    its = c.get("cg: iterations")
    return 100.0 * c.get("cg: budget iterations", 0) / its if its else None
