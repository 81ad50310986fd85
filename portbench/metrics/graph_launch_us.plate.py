"""Host microseconds a CUDA-graph replay of a CG block takes to launch: the
program's ``cg: replay`` scopes opened while no profiler recorded (the
warm-up step and the instrumented window), over their count."""

from portbench.program_registry import unprofiled


def read(rec):
    n, seconds = unprofiled("cg: replay")
    return 1e6 * seconds / n if n else None
