"""The port's J2 plate load steps against the JAX package, in float64 on
the CPU: demos/plane_elastoplasticity.py on 16x32 P2 quads, where the port
takes the banded route (the plain versions of its kernels), 3 steps.
Displacement and plastic strain agree to 1e-8 relative and Newton counts are
equal (the cases and the comparison are those of test_torch_solve.py).
"""

import numpy as np
from test_torch_solve import PKGS, assert_same_run, j2_material, run


def plate(which):
    """demos/plane_elastoplasticity.py: bottom clamped, top pulled in y."""
    pkg, fem, _, forms, _ = PKGS[which]
    V = fem.FunctionSpace(fem.create_rectangle((0, 0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))
    qmap = pkg.QuadratureMap(V, 4, j2_material(which))
    qmap.register_gradient("Strain", forms.mandel_strain_2d())
    bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
    top = fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 2.0), 1), 0.0)
    prob = pkg.NonlinearMaterialProblem(qmap, fem.Function(V), bcs=[fem.DirichletBC(bottom, 0.0), top])
    return prob, qmap, top


def test_banded_plate_matches_jax():
    loads = (0.0025, 0.005, 0.0075)
    tp = plate("torch")
    assert tp[1].domain.banded_active
    assert_same_run(run(*tp, loads), run(*plate("jax"), loads))
