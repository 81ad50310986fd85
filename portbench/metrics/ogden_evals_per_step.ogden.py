"""Whole-mesh Ogden evaluations a fused load step, line-search trials
included: the program's ``hyperelastic: points`` counter over the mesh's
points and over the ``fused: step`` scopes, both while no profiler recorded
(the warm-up protocol and the instrumented window)."""

from portbench.program_registry import counters, unprofiled


def read(rec):
    points, steps = counters().get("hyperelastic: points"), unprofiled("fused: step")[0]
    return points / rec.shapes["n_points"] / steps if points and steps else None
