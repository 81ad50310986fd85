"""A pressurized thick cylinder on curved isoparametric cells against the
Lamé closed form: the torch twin of the JAX package's curved-cylinder demo.

A quarter annulus (R_i = 1, R_e = 2, inner pressure 10) from an N x N
rectangle in polar coordinates, Q2 displacements, symmetry conditions on the
two axes and the pressure as a facet traction; elastic, one Newton solve with
a host LU. ``curve_mesh`` maps the degree-2 geometry nodes exactly onto the
circles; the straight variant maps only the vertices (chords). The hoop
stress at the Gauss points is held against the closed form.

Run: ``python -m dolfinx_materials_tpu_torch.demos.curved_cylinder [N] [cpu]``
"""

from __future__ import annotations

import sys

import numpy as np

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import (
    DirichletBC,
    Function,
    FunctionSpace,
    assemble_traction,
    create_rectangle,
    curve_mesh,
    locate_dofs_geometrical,
)
from ..fem.forms import mandel_strain_2d
from ..models import LinearElasticIsotropic

E, NU = 70e3, 0.3
RI, RE, P = 1.0, 2.0, 10.0


def _polar(x):
    r, th = x[:, 0], x[:, 1]
    return np.stack([r * np.cos(th), r * np.sin(th)], axis=1)


def solve_annulus(N, curved, device=None):
    """Solve on the curved or straight-edged annulus; returns ``(max relative
    hoop-stress error against Lamé, displacement dofs (numpy))``."""
    if curved:
        mesh = curve_mesh(create_rectangle((RI, 0.0), (RE, np.pi / 2), (N, N), "quad"), _polar)
    else:
        mesh = create_rectangle((RI, 0.0), (RE, np.pi / 2), (N, N), "quad")
        mesh.points = _polar(mesh.points)

    V = FunctionSpace(mesh, degree=2, shape=(2,))
    x_axis = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0), 1)
    y_axis = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0), 0)
    mat = Material(LinearElasticIsotropic(E, NU), device=device)
    qmap = QuadratureMap(V, 4, mat)
    qmap.register_gradient("Strain", mandel_strain_2d())
    u = Function(V)
    F = assemble_traction(
        V,
        lambda x: np.linalg.norm(x, axis=1) < RI + 0.5 / N,
        lambda x: P * x / np.linalg.norm(x, axis=1, keepdims=True),
    )
    problem = NonlinearMaterialProblem(
        qmap, u, bcs=[DirichletBC(x_axis, 0.0), DirichletBC(y_axis, 0.0)],
        options={"ksp_type": "lu", "rtol": 1e-12},
    )
    problem.external_force = F
    conv, _ = problem.solve()
    if not conv:
        raise RuntimeError(f"annulus N={N} curved={curved}: Newton did not converge")

    x_q = qmap.domain.x_q.reshape(-1, 2).cpu().numpy()
    r_q = np.linalg.norm(x_q, axis=1)
    sig = mat.data_manager.s0["Stress"].cpu().numpy()
    th = np.arctan2(x_q[:, 1], x_q[:, 0])
    c, s = np.cos(th), np.sin(th)
    sig_tt = sig[:, 0] * s**2 + sig[:, 1] * c**2 - np.sqrt(2) * sig[:, 3] * s * c
    sig_tt_exact = P * RI**2 / (RE**2 - RI**2) * (1 + RE**2 / r_q**2)
    return float(np.max(np.abs(sig_tt - sig_tt_exact) / np.abs(sig_tt_exact))), u.x.copy()


def main(N=6, device=None):
    """Both variants; returns ``{"straight": error, "curved": error}``."""
    print(f"{N}x{N} quarter annulus, P2 displacements, hoop stress vs Lame:")
    errors = {}
    for curved in (False, True):
        err, _ = solve_annulus(N, curved, device)
        errors["curved" if curved else "straight"] = err
        label = "curved (isoparametric Q2 geometry)" if curved else "straight edges"
        print(f"  {label:38s} max rel error {err:.2e}")
    return errors


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 6, device="cpu" if "cpu" in args else None)
