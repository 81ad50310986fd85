"""Host reads of device values a fused load step: the program's ``host
reads`` counter over its ``fused: step`` scopes, both while no profiler
recorded (the warm-up step and the instrumented window)."""

from portbench.program_registry import counters, unprofiled


def read(rec):
    reads, steps = counters().get("host reads"), unprofiled("fused: step")[0]
    return reads / steps if reads and steps else None
