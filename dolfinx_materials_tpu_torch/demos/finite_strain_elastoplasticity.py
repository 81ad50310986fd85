"""3D finite-strain FeFp elastoplasticity: tension of a bar, the torch twin
of the JAX package's ``demos/finite_strain_elastoplasticity.py``.

A 3 x 1 x 1 bar, FeFp J2 plasticity with Voce saturation (E = 70e3, nu =
0.3, sigma_0 = 500, sigma_u = 750, b = 1e2), clamped on the left face, the
right face pulled in x to 5 % elongation through ``solve_adaptive`` from 10
initial steps. ``main`` runs the demo's own discretisation (P1 hexes,
degree-2 quadrature, a host LU per Newton step) and writes the cell-averaged
p (VTK) into ``out_dir``. ``build(N, "tetrahedron")`` meshes the same bar
with degree-2 tetrahedra and degree-4 quadrature under the default Krylov
options (CG, two-level): that discretisation takes the banded route, so on
the card its element gathers, assembly and SpMV launch the take kernels.

Run: ``python -m dolfinx_materials_tpu_torch.demos.finite_strain_elastoplasticity
[N] [tet] [cpu]`` (``tet``: the P2-tet build).
"""

from __future__ import annotations

import os
import sys
import time

import numpy as np

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_box, locate_dofs_geometrical
from ..fem.forms import deformation_gradient_3d
from ..fem.io import write_vtk
from ..models import FeFpJ2Plasticity, LinearElasticIsotropic, VoceHardening
from ..solvers import solve_adaptive
from ..utils.timers import reset_timings, timing

E, NU = 70e3, 0.3
SIG0, SIGU, B = 500.0, 750.0, 1e2
L, W = 3.0, 1.0
STRETCH = 0.05  # 5 % elongation
#: the demo's host LU; the P2-tet build keeps the default Krylov options
LU_OPTIONS = {"ksp_type": "lu", "rtol": 1e-8, "max_it": 30}
OPTIONS = {"rtol": 1e-8, "max_it": 30}


def build(N, cell="hexahedron", device=None):
    """The bar on (3N, N, N) cells of ``cell``: P1 hexes under the demo's
    :data:`LU_OPTIONS`, or P2 tets under :data:`OPTIONS`; degree-``2 degree``
    quadrature. Returns ``dict(problem, qmap, material, V, mesh,
    bc_right)``."""
    hexes = cell == "hexahedron"
    degree = 1 if hexes else 2
    material = Material(FeFpJ2Plasticity(LinearElasticIsotropic(E, NU), VoceHardening(SIG0, SIGU, B)),
                        device=device)
    mesh = create_box((0, 0, 0), (L, W, W), (3 * N, N, N), cell)
    V = FunctionSpace(mesh, degree=degree, shape=(3,))
    qmap = QuadratureMap(V, 2 * degree, material)
    qmap.register_gradient("F", deformation_gradient_3d())
    left = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
    right_x = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], L), 0)
    bc_right = DirichletBC(right_x, 0.0)
    problem = NonlinearMaterialProblem(qmap, Function(V), bcs=[DirichletBC(left, 0.0), bc_right],
                                       options=dict(LU_OPTIONS if hexes else OPTIONS))
    return dict(problem=problem, qmap=qmap, material=material, V=V, mesh=mesh, bc_right=bc_right)


def run(proto, nsteps0=10, n_steps=None):
    """``solve_adaptive`` from ``nsteps0`` steps to the 5 % elongation, or,
    with ``n_steps``, to the first ``n_steps`` of those steps. Returns one
    dict per accepted step: ``load``, ``u``, ``newton``, ``cg`` (iterations)
    and ``seconds``; failed attempts are in ``proto["cutbacks"]``."""
    problem = proto["problem"]
    solve = problem.solve
    steps, cutbacks = [], []

    def recording():
        out = solve()
        m = problem.metrics
        rec = dict(load=float(proto["bc_right"].value), newton=m["newton_iterations"],
                   cg=int(sum(m["cg_iterations"])), seconds=m["wall_time_s"])
        if out[0]:
            steps.append(dict(rec, u=problem.u.x.copy()))
        else:
            cutbacks.append(rec)
        return out

    problem.solve = recording
    try:
        target = STRETCH * L if n_steps is None else STRETCH * L * n_steps / nsteps0
        solve_adaptive(problem, proto["bc_right"].set, target, nsteps0=nsteps0 if n_steps is None else n_steps)
    finally:
        problem.solve = solve
    proto["cutbacks"] = cutbacks
    return steps


def main(N=4, device=None, out_dir=".", cell="hexahedron"):
    """The demo on P1 hexes (``cell="tetrahedron"``: the P2-tet build);
    returns ``dict(steps, max_p, mean_pk1_xx, qmap, wall_s)``: the accepted
    loads, the largest cell-averaged p, the mean PK1_xx over the Gauss
    points and the wall seconds."""
    proto = build(N, cell, device=device)
    reset_timings()
    t0 = time.perf_counter()
    steps = run(proto)
    wall = time.perf_counter() - t0
    qmap, V = proto["qmap"], proto["V"]
    p_cells = qmap.project_on("p", ("DG", 0))
    write_vtk(os.path.join(out_dir, "finite_strain_bar.vtk"), proto["mesh"], cell_data={"p": p_cells})
    pk1 = np.asarray(proto["material"].data_manager.s0["PK1"].cpu())
    out = dict(steps=[s["load"] for s in steps], max_p=float(p_cells.max()), mean_pk1_xx=float(pk1[:, 0].mean()),
               qmap=qmap, wall_s=wall)
    attempts = steps + proto["cutbacks"]
    print(f"gauss points: {qmap.num_points}, dofs: {V.num_dofs}, device: {proto['material'].device}")
    print(f"{len(steps)} steps accepted, {len(proto['cutbacks'])} cut back, newton={sum(a['newton'] for a in attempts)}"
          f" cg={sum(a['cg'] for a in attempts)}")
    print(f"{len(steps)} steps in {wall:.1f}s; max p = {out['max_p']:.4f}; mean PK1_xx = {out['mean_pk1_xx']:.1f}")
    split = {k: timing(f"solver: {k}")[1] for k in ("constitutive update", "jacobian assembly", "linear solve")}
    split["residual and line search"] = timing("solver: Newton solve")[1] - sum(split.values())
    print("time split: " + ", ".join(f"{k} {v:.2f}s" for k, v in split.items()))
    return out


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 4, device="cpu" if "cpu" in args else None,
         cell="tetrahedron" if "tet" in args else "hexahedron")
