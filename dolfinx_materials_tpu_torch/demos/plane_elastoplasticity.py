"""Plane-strain elastoplasticity of a plate under tension (J2 + Voce
hardening): the torch twin of the JAX package's main demo.

A 1 x 2 plate of N x 2N Q2 quads (degree-4 quadrature: 36 N^2 Gauss points),
clamped at the bottom, the top pulled in y to 6 sigma_0 / E * L_y through
``solve_adaptive`` from 20 initial steps, each Newton step a host LU solve.
On the card every constitutive update is the J2 kernel (K1, with the Voce
law in closed form), and the gathers and assembly of the degree-2 dofmap go
through the banded take kernels (K3/K4) once the plate has 8,192 element
dofs or more (N >= 6). It writes the force-displacement curve (CSV) and the
cell-averaged accumulated plastic strain p (VTK) into ``out_dir``.

Run: ``python -m dolfinx_materials_tpu_torch.demos.plane_elastoplasticity
[N] [cpu]`` (N = 24: 10,368 Gauss points, 9,506 dofs).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_rectangle, locate_dofs_geometrical
from ..fem.forms import mandel_strain_2d
from ..fem.io import write_vtk
from ..models import LinearElasticIsotropic, VoceHardening, vonMisesIsotropicHardening
from ..solvers import solve_adaptive
from ..utils.timers import list_timings, reset_timings

E, NU = 70e3, 0.3
SIG0, SIGU, B = 350.0, 500.0, 1e3
LX, LY = 1.0, 2.0


def main(N=24, device=None, out_dir="."):
    """Run the load program; returns ``dict(steps, forces, max_p, qmap,
    wall_s)``: the accepted top displacements, the reaction force at each,
    the largest cell-averaged p, the quadrature map (its state is the last
    step's) and the wall seconds of the load program."""
    material = Material(
        vonMisesIsotropicHardening(LinearElasticIsotropic(E, NU), VoceHardening(SIG0, SIGU, B)),
        device=device,
    )
    mesh = create_rectangle((0, 0), (LX, LY), (N, 2 * N), "quad")
    V = FunctionSpace(mesh, degree=2, shape=(2,))
    qmap = QuadratureMap(V, 4, material)
    qmap.register_gradient("Strain", mandel_strain_2d())

    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
    top_y = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], LY), 1)
    bc_top = DirichletBC(top_y, 0.0)
    u = Function(V)
    problem = NonlinearMaterialProblem(
        qmap, u, bcs=[DirichletBC(bottom, 0.0), bc_top],
        options={"ksp_type": "lu", "rtol": 1e-8, "atol": 1e-8, "max_it": 30},
    )
    qmap.update(u.x)  # warm-up: builds the kernel launch (and the kernels, on first use)
    reset_timings()

    # the clamped corners and the sharp Voce saturation make large fixed
    # steps fail: solve_adaptive cuts them back
    forces, steps = [], []
    solve = problem.solve

    def solve_and_record():
        out = solve()
        if out[0]:
            steps.append(float(bc_top.value))
            forces.append(float(problem._residual(u.x)[top_y].sum()))
        return out

    problem.solve = solve_and_record
    t0 = time.perf_counter()
    solve_adaptive(problem, bc_top.set, 6 * SIG0 / E * LY, nsteps0=20)
    wall = time.perf_counter() - t0

    p_cells = qmap.project_on("p", ("DG", 0))
    write_vtk(os.path.join(out_dir, "plane_elastoplasticity.vtk"), mesh, cell_data={"p": p_cells})
    np.savetxt(
        os.path.join(out_dir, "plane_elastoplasticity_force.csv"),
        np.column_stack([steps, forces, [0] * len(steps)]),
        header="uy force newton_iters",
    )
    print(f"gauss points: {qmap.num_points}, dofs: {V.num_dofs}, device: {material.device}")
    print(f"{len(steps)} load steps in {wall:.2f}s; max p = {p_cells.max():.4f}")
    list_timings()
    return dict(steps=steps, forces=forces, max_p=float(p_cells.max()), qmap=qmap, wall_s=wall)


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 24, device="cpu" if "cpu" in args else None)
