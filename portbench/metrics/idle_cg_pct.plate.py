"""The device's idle that the masked CG's host path owns, in % of the
profiled window: the gaps whose innermost host event is the program's span
``cg: solve`` or ``cg: replay``. Left out: the gaps inside them that a
runtime call or an operator owns (``cudaGraphLaunch``, the block flag's
``cudaStreamSynchronize`` and copy), which the breakdown names."""

from portbench.program_registry import idle_owned_pct


def read(rec):
    return idle_owned_pct(rec, ("cg: solve", "cg: replay"))
