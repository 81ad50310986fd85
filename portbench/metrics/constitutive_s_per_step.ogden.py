"""Host seconds of the Ogden update a fused load step: the program's
``hyperelastic: constitutive update`` and ``hyperelastic: flux`` scopes
opened while no profiler recorded (the warm-up protocol and the instrumented
window), over the ``fused: step`` scopes opened then. The scopes do not
synchronise: a call's host time, the launches it enqueues and any wait for
room in the launch queue."""

from portbench.program_registry import unprofiled

SCOPES = ("hyperelastic: constitutive update", "hyperelastic: flux")


def read(rec):
    calls = sum(unprofiled(s)[0] for s in SCOPES)
    steps = unprofiled("fused: step")[0]
    return sum(unprofiled(s)[1] for s in SCOPES) / steps if calls and steps else None
