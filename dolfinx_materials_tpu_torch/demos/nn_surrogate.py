"""A neural-network surrogate constitutive model inside a FEM solve: the
torch twin of the JAX package's ``demos/nn_surrogate.py``.

Stress-strain data from an isotropic elastic law (2,048 strains from numpy's
``default_rng(0)``) train an MLP surrogate (6-48-48-6, Adam); wrapped in a
``Material``, its consistent tangent is the network's exact derivative, so
the Newton solve of a unit square in tension works unchanged. The
displacements are compared with the solve on the ground-truth material.

Run: ``python -m dolfinx_materials_tpu_torch.demos.nn_surrogate [steps] [cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_unit_square, locate_dofs_geometrical
from ..fem.forms import mandel_strain_2d
from ..models import LinearElasticIsotropic, NeuralBehavior
from ..ops import tensors as tn


def main(steps=3000, device=None):
    """Returns ``dict(history, err, iterations)``: the training loss
    history, the relative displacement error of the surrogate's solve
    against the ground truth, and the two Newton counts."""
    E, nu = 70e3, 0.3
    rng = np.random.default_rng(0)
    eps_data = rng.normal(size=(2048, 6)) * 1e-3
    sig_data = eps_data @ tn.isotropic_C(E, nu).T
    surrogate = NeuralBehavior(layers=(6, 48, 48, 6), input_scale=1e3, output_scale=100.0)
    hist = surrogate.fit(eps_data, sig_data, steps=steps, learning_rate=3e-3, device=device)
    print(f"training: loss {hist[0]:.3e} -> {hist[-1]:.3e}")

    def solve_with(mat):
        V = FunctionSpace(create_unit_square(8, 8, "quad"), 1, (2,))
        qmap = QuadratureMap(V, 2, mat)
        qmap.register_gradient("Strain", mandel_strain_2d())
        left = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0)
        bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1)
        right = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0)
        u = Function(V)
        prob = NonlinearMaterialProblem(
            qmap, u, bcs=[DirichletBC(left, 0.0), DirichletBC(bottom, 0.0), DirichletBC(right, 1e-3)],
            options={"ksp_type": "lu", "rtol": 1e-8, "atol": 1e-6},
        )
        converged, it = prob.solve()
        if not converged:
            raise RuntimeError(f"{mat.name}: the solve did not converge")
        return u.x, it

    u_nn, it_nn = solve_with(Material(surrogate, device=device))
    u_ref, it_ref = solve_with(Material(LinearElasticIsotropic(E, nu), device=device))
    err = float(np.linalg.norm(u_nn - u_ref) / np.linalg.norm(u_ref))
    print(f"FEM with NN surrogate: {it_nn} Newton its (exact AD tangents of the net); "
          f"displacement error vs ground truth: {err:.2%}")
    return dict(history=hist, err=err, iterations=(it_nn, it_ref), u=u_nn)


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 3000, device="cpu" if "cpu" in args else None)
