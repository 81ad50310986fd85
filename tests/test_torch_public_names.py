"""The public names of the JAX package's package and module interfaces that a
user imports, each present in the port's counterpart module."""

import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("dolfinx_materials_tpu")

NAMES = [
    ("", "fit_parameters"), ("", "make_path_simulator"),
    (".ops", "tensors"), (".ops", "newton_solve"), (".ops", "scalar_newton_solve"),
    (".utils", "timer"), (".utils", "timing"), (".utils", "list_timings"), (".utils", "reset_timings"),
    (".ops.banded_gather", "banded_take"),
    (".parallel.sharding", "make_sharded_blocked_step"),
]


@pytest.mark.parametrize("module,name", NAMES, ids=[f"{m or '.'}:{n}" for m, n in NAMES])
def test_the_ports_module_exports_the_jax_name(module, name):
    jax_mod = importlib.import_module("dolfinx_materials_tpu" + module)
    port_mod = importlib.import_module("dolfinx_materials_tpu_torch" + module)
    assert hasattr(jax_mod, name)
    assert hasattr(port_mod, name), f"dolfinx_materials_tpu_torch{module} lacks {name}"


def test_exported_names_are_the_defining_modules_objects():
    from dolfinx_materials_tpu_torch import calibration, fit_parameters, make_path_simulator
    from dolfinx_materials_tpu_torch.ops import newton, newton_solve, scalar_newton_solve, tensors
    from dolfinx_materials_tpu_torch.utils import list_timings, reset_timings, timer, timers, timing

    assert (fit_parameters, make_path_simulator) == (calibration.fit_parameters, calibration.make_path_simulator)
    assert (newton_solve, scalar_newton_solve) == (newton.newton_solve, newton.scalar_newton_solve)
    assert tensors.__name__ == "dolfinx_materials_tpu_torch.ops.tensors"
    assert (timer, timing, list_timings, reset_timings) == (timers.timer, timers.timing, timers.list_timings,
                                                            timers.reset_timings)


def test_sharding_forwards_make_sharded_blocked_step(monkeypatch):
    """parallel.sharding.make_sharded_blocked_step hands its arguments to
    parallel.blocked's, imported at the call."""
    from dolfinx_materials_tpu_torch.parallel import blocked, sharding

    seen = []
    monkeypatch.setattr(blocked, "make_sharded_blocked_step", lambda *a, **k: seen.append((a, k)) or "step")
    assert sharding.make_sharded_blocked_step(1, 2, n_newton=3) == "step"
    assert seen == [((1, 2), {"n_newton": 3})]


def test_scalar_newton_solve_runs_from_the_ops_namespace():
    """The exported root finder solves x^3 = 2 per point."""
    from dolfinx_materials_tpu_torch.ops import scalar_newton_solve

    b = torch.tensor([2.0, 8.0], dtype=torch.float64)
    x, ok = torch.vmap(lambda bi: scalar_newton_solve(lambda x, bi: x ** 3 - bi, bi.new_ones(()), (bi,)))(b)
    assert bool(ok.all())
    np.testing.assert_allclose(x.numpy(), np.cbrt([2.0, 8.0]), rtol=1e-12)
