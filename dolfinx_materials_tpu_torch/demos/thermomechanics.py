"""Staggered thermo-mechanical coupling: the torch twin of the JAX
package's ``demos/thermomechanics.py``.

A 2 x 1 plate of 2N x N quads: nonlinear conduction (k(T) = 1 / (A + B T))
from a hot left edge (T0 + 400 K) to the right edge at T0, then
thermo-elasticity with the plate clamped on both vertical edges, fed with
the converged Gauss-point temperature as its external state variable. Both
maps share the mesh and the quadrature, so the Gauss points coincide and the
field is handed over without projection.

Run: ``python -m dolfinx_materials_tpu_torch.demos.thermomechanics [N] [cpu]``.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_rectangle, locate_dofs_geometrical
from ..fem.forms import mandel_strain_2d, scalar_gradient, scalar_value
from ..fem.io import write_vtk
from ..models import NonlinearHeatTransfer, ThermoElasticIsotropic


def main(N=16, device=None, out_dir="."):
    """Returns ``dict(T, u, stress, iterations)``: nodal T, displacements,
    the Gauss-point stresses and the two solves' Newton counts. Writes
    ``thermomechanics.vtk`` into ``out_dir``."""
    E, nu, alpha_th, T0 = 70e3, 0.3, 1e-5, 293.15
    T_hot = T0 + 400.0
    mesh = create_rectangle((0, 0), (2.0, 1.0), (2 * N, N), "quad")

    VT = FunctionSpace(mesh, 1, ())
    mat_T = Material(NonlinearHeatTransfer(A=0.0375, B=2.165e-4, dim=2), device=device)
    qmap_T = QuadratureMap(VT, 2, mat_T)
    qmap_T.register_gradient("TemperatureGradient", scalar_gradient())
    qmap_T.register_external_state_variable("Temperature", scalar_value())
    left = locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 0.0))
    right = locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 2.0))
    T = Function(VT)
    T.x[:] = T0
    heat = NonlinearMaterialProblem(
        qmap_T, T, bcs=[DirichletBC(left, T_hot), DirichletBC(right, T0)],
        residual_terms=[[("HeatFlux", scalar_gradient())]], options={"ksp_type": "lu", "atol": 1e-8},
    )
    converged, it_T = heat.solve()
    if not converged:
        raise RuntimeError("thermal solve did not converge")

    Vu = FunctionSpace(mesh, 1, (2,))
    mat_u = Material(ThermoElasticIsotropic(E, nu, alpha_th, T0), device=device)
    qmap_u = QuadratureMap(Vu, 2, mat_u)
    qmap_u.register_gradient("Strain", mandel_strain_2d())
    # same mesh and quadrature: the Gauss points coincide, hand the field over
    T_gauss = qmap_T._eval_fns["Temperature"](torch.as_tensor(T.x, dtype=qmap_T.dtype, device=qmap_T.device))
    qmap_u.register_external_state_variable("Temperature", T_gauss)

    clamped = locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 0], 2.0))
    u = Function(Vu)
    mech = NonlinearMaterialProblem(qmap_u, u, bcs=[DirichletBC(clamped, 0.0)], options={"ksp_type": "lu"})
    converged, it_u = mech.solve()
    if not converged:
        raise RuntimeError("mechanical solve did not converge")

    sig = mat_u.data_manager.s0["Stress"].cpu().numpy()
    _, vals = qmap_u.project_on("Stress", ("P", 1))
    write_vtk(os.path.join(out_dir, "thermomechanics.vtk"), mesh,
              point_data={"T": T.x, "sxx": vals[:, 0], "u": u.x.reshape(-1, 2)})
    print(f"thermal solve: {it_T} its; mechanical solve: {it_u} its; device: {mat_u.device}")
    print(f"max |T| = {T.x.max():.1f} K, min sig_xx = {sig[:, 0].min():.1f} (compressive near the hot edge)")
    return dict(T=T.x.copy(), u=u.x.copy(), stress=sig, iterations=(it_T, it_u))


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 16, device="cpu" if "cpu" in args else None)
