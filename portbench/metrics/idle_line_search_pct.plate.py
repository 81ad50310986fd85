"""The device's idle that the fused step's line search owns, in % of the
profiled window: the gaps whose innermost host event is the program's span
``fused: line search``. Left out: the gaps inside it that a runtime call or
an operator owns (the trial norms' synchronisations and copies)."""

from portbench.program_registry import idle_owned_pct


def read(rec):
    return idle_owned_pct(rec, ("fused: line search",))
