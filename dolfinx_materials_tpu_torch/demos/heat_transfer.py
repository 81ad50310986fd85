"""Nonlinear heat transfer and transient phase change: the torch twin of
the JAX package's ``demos/heat_transfer.py``.

``stationary``: conduction with k(T) = 1 / (A + B T) on a 1 x 0.2 strip,
T = 300 K on the left and 800 K on the right, against the Kirchhoff-transform
closed form of the constant flux. ``phase_change``: a 0.1 m bar initially
50 K below the melting point, its left end held 150 K above it; a
theta-scheme (theta = 1) residual with the enthalpy internal state variable,
15 steps of 2 s, a time series of T (``TimeSeriesWriter``) and the melting
front at each step. Both run the generic path (an external state variable,
the temperature) with a host LU per Newton step.

Run: ``python -m dolfinx_materials_tpu_torch.demos.heat_transfer [cpu]``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_rectangle, locate_dofs_geometrical
from ..fem.forms import scalar_gradient, scalar_value
from ..fem.io import TimeSeriesWriter, write_vtk
from ..models import NonlinearHeatTransfer, PhaseChangeHeatTransfer

A, B = 0.0375, 2.165e-4
T0, T1 = 300.0, 800.0


def stationary(nx=40, device=None):
    """Returns ``dict(iterations, flux_err, T)``: the Newton count, the
    relative error of the mean flux against the closed form, and the nodal
    temperatures."""
    mesh = create_rectangle((0, 0), (1.0, 0.2), (nx, max(2, nx // 10)), "quad")
    V = FunctionSpace(mesh, 1, ())
    mat = Material(NonlinearHeatTransfer(A=A, B=B, dim=2), device=device)
    qmap = QuadratureMap(V, 2, mat)
    qmap.register_gradient("TemperatureGradient", scalar_gradient())
    qmap.register_external_state_variable("Temperature", scalar_value())
    left = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0))
    T = Function(V)
    T.x[:] = T0
    problem = NonlinearMaterialProblem(
        qmap, T, bcs=[DirichletBC(left, T0), DirichletBC(right, T1)],
        residual_terms=[[("HeatFlux", scalar_gradient())]], options={"ksp_type": "lu", "atol": 1e-8},
    )
    converged, it = problem.solve()
    if not (converged and it < 10):
        raise RuntimeError(f"stationary heat solve: converged={converged} after {it} iterations")
    j = mat.data_manager.s0["HeatFlux"].cpu().numpy()
    j_exact = np.log((A + B * T1) / (A + B * T0)) / B
    err = abs(-j[:, 0].mean() - j_exact) / j_exact
    print(f"stationary: {it} Newton its, flux error {err:.2e}")
    return dict(iterations=it, flux_err=err, T=T.x.copy())


def phase_change(nx=60, nsteps=15, device=None, out_dir="."):
    """Returns ``dict(fronts, T, enthalpy)``: the melting front after each
    step, and the last step's nodal T and Gauss-point enthalpy. Writes
    ``phase_change.pvd`` (with one VTK file a step) and ``phase_change.vtk``
    into ``out_dir``."""
    beh = PhaseChangeHeatTransfer(Tsmooth=5.0, dim=2)
    L = 0.1
    mesh = create_rectangle((0, 0), (L, L / nx), (nx, 1), "quad")
    V = FunctionSpace(mesh, 1, ())
    mat = Material(beh, device=device)
    qmap = QuadratureMap(V, 2, mat)
    qmap.register_gradient("TemperatureGradient", scalar_gradient())
    qmap.register_external_state_variable("Temperature", scalar_value())

    T = Function(V)
    T.x[:] = beh.Tm - 50.0
    left = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
    dtv = 2.0
    problem = NonlinearMaterialProblem(
        qmap, T, bcs=[DirichletBC(left, beh.Tm + 150.0)],
        residual_terms=[[("Enthalpy", scalar_value()), ("HeatFlux", scalar_gradient(), lambda: -dtv)]],
        options={"ksp_type": "lu", "atol": 1e-2, "max_it": 50},
    )
    qmap.update(T.x)
    qmap.advance()
    ext = qmap.domain.make_residual([scalar_value()])
    series = TimeSeriesWriter(os.path.join(out_dir, "phase_change"), mesh)
    series.write(0.0, point_data={"T": T.x})
    fronts = []
    x = V.node_coords[:, 0]
    for step in range(nsteps):
        problem.external_force = ext(torch.as_tensor(T.x, device=mat.device), [mat.data_manager.s0["Enthalpy"]])
        converged, _ = problem.solve()
        if not converged:
            raise RuntimeError(f"phase change: step {step} did not converge")
        molten = T.x > beh.Tm
        fronts.append(x[molten].max() if molten.any() else 0.0)
        series.write((step + 1) * dtv, point_data={"T": T.x})
    write_vtk(os.path.join(out_dir, "phase_change.vtk"), mesh, point_data={"T": T.x})
    print(f"phase change: melting front at t={nsteps * dtv:.0f}s: {fronts[-1]:.4f} m "
          f"(monotone: {bool((np.diff(fronts) >= 0).all())})")
    return dict(fronts=fronts, T=T.x.copy(), enthalpy=mat.data_manager.s0["Enthalpy"].cpu().numpy())


if __name__ == "__main__":
    dev = "cpu" if "cpu" in sys.argv[1:] else None
    stationary(device=dev)
    phase_change(device=dev)
