"""The fused blocked step on a pair whose mechanics behavior has a per-point
material property and a rotated frame (tests/test_sharding_general.py's
``test_blocked_step_props_and_rotation``), in both packages, in float64 on
the CPU: the first test of the port's inherited property and rotation paths
in ``parallel/blocked.py``'s ``_BlockedTerm``. The pair and the package
tables are tests/test_torch_blocked.py's."""

import os
import sys

import numpy as np
import pytest
import torch

pytest.importorskip("dolfinx_materials_tpu")
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_blocked import E, NU, PKGS, T0, close, couplings, host  # noqa: E402

from dolfinx_materials_tpu_torch import parallel as tpar  # noqa: E402

torch.set_num_threads(1)


def fiber_behavior(P, nu=NU, alpha_th=1e-3):
    """tests/test_sharding_general.py's ``VaryingFiberThermoElastic`` in
    package P: isotropic thermo-elasticity with a per-point Young modulus
    (a material property) and a fiber stiffening along the material x-axis,
    so that the frame's rotation shows in the answer."""
    xp, tn = P["xp"], P["pkg"].ops.tensors

    class VaryingFiberThermoElastic(P["models"].base.Behavior):
        material_properties = {"YoungModulus": 1}

        def __init__(self):
            self.gradients = {"Strain": 6}
            self.fluxes = {"Stress": 6}
            self.external_state_variables = {"Temperature": 1}
            self.extra_tangent_blocks = [("Stress", "Temperature")]

        def constitutive_update(self, inputs, state, dt):
            Ev, eps, T = inputs["YoungModulus"], inputs["Strain"], inputs["Temperature"][0]
            I2 = xp.asarray(tn.I2, dtype=eps.dtype)
            e = eps - alpha_th * (T - T0) * I2
            lmbda = Ev * nu / (1 + nu) / (1 - 2 * nu)
            mu = Ev / 2 / (1 + nu)
            sig = lmbda * tn.tr(e) * I2 + 2 * mu * e
            x_axis = xp.asarray(np.eye(6)[0], dtype=eps.dtype)
            return {"Stress": sig + 0.4 * Ev * e[0] * x_axis}, state

    return VaryingFiberThermoElastic()


def props_and_rotation(P, N=6, angle=0.25, rotate=True, ksp=None):
    """tests/test_sharding_general.py's blocked case with material
    properties and a rotation: the thermo-mechanical pair, its mechanics
    behavior the fiber law with E (1 + x / 2) at each Gauss point and its
    frame rotated by ``angle`` about z."""
    fem, pkg, forms, th = P["fem"], P["pkg"], P["forms"], P["thermal"]
    mesh = fem.create_rectangle((0, 0), (1.0, 1.0), (N, N), "quad")
    VT = fem.FunctionSpace(mesh, 1, ())
    qT = pkg.QuadratureMap(VT, 2, pkg.Material(th.ThermoMechanicalHeat(k=1.0, kappa=1.0, chi=6e3, T0=T0), **P["kw"]))
    qT.register_gradient("TemperatureGradient", forms.scalar_gradient())
    qT.register_external_state_variable("Temperature", forms.scalar_value())
    T = fem.Function(VT)
    T.x[:] = T0
    heat = pkg.NonlinearMaterialProblem(
        qT, T, bcs=[fem.DirichletBC(fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 0.0)), T0 + 50.0),
                    fem.DirichletBC(fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 1.0)), T0)],
        residual_terms=[[("HeatFlux", forms.scalar_gradient(), -1.0), ("Source", forms.scalar_value(), 1.0)]],
        options={"ksp_type": "lu"})
    Vu = fem.FunctionSpace(mesh, 1, (2,))
    mat_u = pkg.Material(fiber_behavior(P), **P["kw"])
    if rotate:
        c, s = np.cos(angle), np.sin(angle)
        mat_u.rotation_matrix = P["xp"].asarray(np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]]))
    qu = pkg.QuadratureMap(Vu, 2, mat_u)
    qu.register_gradient("Strain", forms.mandel_strain_2d())
    qu.register_external_state_variable("Temperature", T0)
    x_q = host(qu.domain.x_q).reshape(-1, qu.domain.x_q.shape[-1])
    mat_u.update_material_property("YoungModulus", E * (1.0 + 0.5 * x_q[:, 0]))
    clamped = fem.locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 0], 1.0))
    mech = pkg.NonlinearMaterialProblem(qu, fem.Function(Vu), bcs=[fem.DirichletBC(clamped, 0.0)],
                                        options={"ksp_type": "lu"})
    return P["solvers"].BlockedNonlinearProblem([heat, mech], couplings(P, qT, qu),
                                                options=None if ksp is None else {"ksp_type": ksp})


def host_lu(P, **kw):
    blocked = props_and_rotation(P, ksp="lu", **kw)
    assert blocked.solve()[0]
    return np.concatenate([p.u.x for p in blocked.problems])


def test_blocked_step_props_and_rotation_matches_jax_host_solver():
    """The port's fused blocked step (16 Newton x 400 BiCGStab) on the pair
    with a per-point Young modulus and a frame rotated 0.25 rad: |R| below
    1e-7 E, z against the JAX package's host LU solve and against the
    port's own at tests/test_sharding_general.py's tolerances (rtol 1e-6,
    atol 1e-8 of max(1, max |z|)); the two host solves agree to 1e-8 of
    the scale, and without the rotation the answer moves by more than that."""
    P = PKGS["torch"]
    blocked = props_and_rotation(P)
    step, pad = tpar.make_sharded_blocked_step(blocked, tpar.device_mesh(1, devices=["cpu"]), n_newton=16, n_cg=400)
    mask, vals = blocked._masks()
    z0 = np.concatenate([p.u.x for p in blocked.problems])
    z0[host(mask)] = host(vals)[host(mask)]
    states0 = [p.qmaps[0].material.data_manager.s0.internal for p in blocked.problems]
    z, _, rn = step(torch.as_tensor(z0), pad(states0), mask, vals, 0.0)
    assert float(rn) < 1e-7 * E
    z_jax, z_port = host_lu(PKGS["jax"]), host_lu(P)
    scale = max(1.0, float(np.abs(z_jax).max()))
    for z_ref in (z_jax, z_port):
        np.testing.assert_allclose(host(z), z_ref, rtol=1e-6, atol=1e-8 * scale)
    close(z_port, z_jax)
    assert np.abs(host_lu(P, rotate=False) - z_port).max() > 1e-8 * scale
