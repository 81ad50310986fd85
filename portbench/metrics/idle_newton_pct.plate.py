"""The device's idle that the fused step's host Newton owns, in % of the
profiled window: the gaps whose innermost host event is the program's span
``fused: step`` (so neither a CG solve nor the line search, which own
theirs). Left out: the gaps inside it that a runtime call or an operator
owns (the residual norms' synchronisations and copies)."""

from portbench.program_registry import idle_owned_pct


def read(rec):
    return idle_owned_pct(rec, ("fused: step",))
