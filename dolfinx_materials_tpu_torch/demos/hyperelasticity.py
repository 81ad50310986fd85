"""3D Ogden hyperelasticity: 20 % compression of a unit cube, the torch twin
of the JAX package's hyperelasticity demo.

N^3 P1 hexes, bottom clamped, the top face pushed down in z through
``solve_adaptive`` from 8 initial steps, each Newton step a host LU solve;
the Ogden law (mu = 0.4 MPa, alpha = 28.8, K = 1 GPa, the upstream MFront
parameters) through its batched update, float64.

Run: ``python -m dolfinx_materials_tpu_torch.demos.hyperelasticity [N] [cpu]``
"""

from __future__ import annotations

import sys
import time

import numpy as np

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_unit_cube, locate_dofs_geometrical
from ..fem.forms import deformation_gradient_3d
from ..models import Ogden
from ..solvers import solve_adaptive
from ..utils.timers import list_timings, reset_timings


def main(N=4, device=None):
    """Returns ``(accepted loads, displacement dofs (numpy))``."""
    material = Material(Ogden(mu=(0.4e6,), alpha=(28.8,), K=1e9), device=device)
    V = FunctionSpace(create_unit_cube(N, N, N, "hexahedron"), degree=1, shape=(3,))
    qmap = QuadratureMap(V, 2, material)
    qmap.register_gradient("F", deformation_gradient_3d())

    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 2], 0.0))
    bc_top = DirichletBC(locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 2], 1.0), 2), 0.0)
    u = Function(V)
    problem = NonlinearMaterialProblem(
        qmap, u, bcs=[DirichletBC(bottom, 0.0), bc_top], options={"ksp_type": "lu", "rtol": 1e-8, "max_it": 25}
    )
    reset_timings()
    t0 = time.perf_counter()
    accepted = solve_adaptive(problem, lambda t: bc_top.set(-t), 0.2, nsteps0=8)
    wall = time.perf_counter() - t0
    print(f"gauss points: {qmap.num_points}, dofs: {V.num_dofs}, device: {material.device}")
    print(f"20% compression in {len(accepted)} steps, {wall:.1f}s")
    list_timings()
    return accepted, u.x.copy()


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 4, device="cpu" if "cpu" in args else None)
