"""A stiffly two-way-coupled thermo-mechanical plate for the blocked solvers.

Heat conduction with a dilatation source and thermo-elasticity on one N x N
quad mesh of the unit square: the mechanical material takes the temperature
as an external state variable and the heat material the volumetric strain,
so the monolithic operator has cross-field blocks both ways (the problem of
the JAX package's ``tests/test_blocked.py``, ``build`` and ``couplings``).
Both materials carry external state variables, so they take the generic
constitutive path. The left edge is held at T0 + 50 and the right at T0;
the plate is clamped on both vertical edges.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_rectangle, locate_dofs_geometrical
from ..fem.forms import mandel_strain_2d, scalar_gradient, scalar_value
from ..models import ThermoElasticIsotropic, ThermoMechanicalHeat

E, NU, ALPHA_TH, T0 = 70e3, 0.3, 1e-3, 293.15


def vol_strain(ctx):
    """The volumetric strain tr(grad u): the heat material's VolStrain."""
    return torch.stack([ctx.grad[0, 0] + ctx.grad[1, 1]])


def build(N=6, device=None):
    """``(heat, mech, qT, qu, couplings)``: the two single-field problems
    (host LU options), their maps and the
    :class:`~dolfinx_materials_tpu_torch.solvers.BlockedNonlinearProblem`
    couplings (Stress by Temperature, Source by VolStrain)."""
    mesh = create_rectangle((0, 0), (1.0, 1.0), (N, N), "quad")
    VT = FunctionSpace(mesh, 1, ())
    qT = QuadratureMap(VT, 2, Material(ThermoMechanicalHeat(k=1.0, kappa=1.0, chi=6e3, T0=T0), device=device))
    qT.register_gradient("TemperatureGradient", scalar_gradient())
    qT.register_external_state_variable("Temperature", scalar_value())
    T = Function(VT)
    T.x[:] = T0
    heat = NonlinearMaterialProblem(
        qT, T, bcs=[DirichletBC(locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 0.0)), T0 + 50.0),
                    DirichletBC(locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 1.0)), T0)],
        residual_terms=[[("HeatFlux", scalar_gradient(), -1.0), ("Source", scalar_value(), 1.0)]],
        options={"ksp_type": "lu"})
    Vu = FunctionSpace(mesh, 1, (2,))
    qu = QuadratureMap(Vu, 2, Material(ThermoElasticIsotropic(E, NU, ALPHA_TH, T0), device=device))
    qu.register_gradient("Strain", mandel_strain_2d())
    qu.register_external_state_variable("Temperature", T0)
    clamped = locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 0], 1.0))
    mech = NonlinearMaterialProblem(qu, Function(Vu), bcs=[DirichletBC(clamped, 0.0)], options={"ksp_type": "lu"})
    return heat, mech, qT, qu, [(1, 0, qu, "Stress", "Temperature", scalar_value()),
                                (0, 1, qT, "Source", "VolStrain", vol_strain)]

