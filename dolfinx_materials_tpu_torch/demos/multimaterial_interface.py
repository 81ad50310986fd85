"""Multi-material composite with an elastic interface law (blocked solve):
the torch twin of the JAX package's ``demos/multimaterial_interface.py``.

A 1 x 0.5 plate split at x = 0.6 into a matrix (left) and a stiffer
inclusion strip (right), two displacement fields on the two submeshes
(dofs duplicated along the interface), a plastic material on each (linear
hardening in the matrix, Voce in the inclusion), joined by t = K [[u]]. The
left edge is held in x, both bottoms in y, and the inclusion's right edge
pulled by a traction of 260; the monolithic blocked Newton solves both
fields and the interface coupling in one operator (host LU).

Run: ``python -m dolfinx_materials_tpu_torch.demos.multimaterial_interface [cpu]``.
"""

from __future__ import annotations

import sys

import numpy as np

from .. import BlockedNonlinearProblem, Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import (
    DirichletBC,
    Function,
    FunctionSpace,
    InterfaceDomain,
    InterfaceTerm,
    create_rectangle,
    elastic_interface,
    extract_submesh,
    interface_facets,
    locate_dofs_geometrical,
)
from ..fem.facets import assemble_traction
from ..fem.forms import mandel_strain_2d
from ..models import LinearElasticIsotropic, LinearHardening, VoceHardening, vonMisesIsotropicHardening

#: the interface stiffness and the traction on the inclusion's right edge
#: (sigma_eq ~ 231 in plane strain: the matrix yields)
K_INTERFACE, S_LOAD = 1e5, 260.0


def build(nx=20, ny=10, degree=1, device=None, pull=None):
    """The two-field problem on an ``nx`` x ``ny`` parent of quads of
    ``degree`` (quadrature degree 2 ``degree``): ``dict(blocked, problems,
    materials, qmaps, interface, spaces, start)``.

    ``pull``: the inclusion's right edge is held at u_x = ``pull`` in place
    of the traction (the fused blocked step takes its load through the
    Dirichlet values), and ``start`` is the uniform stretch u_x = ``pull`` x
    over both fields (zero without ``pull``)."""
    parent = create_rectangle((0, 0), (1.0, 0.5), (nx, ny), "quad")
    centers = parent.cell_centers()
    cells_m = np.nonzero(centers[:, 0] < 0.6)[0].astype(np.int32)
    cells_i = np.nonzero(centers[:, 0] > 0.6)[0].astype(np.int32)
    mesh_m, vmap_m = extract_submesh(parent, cells_m)
    mesh_i, vmap_i = extract_submesh(parent, cells_i)
    Vm = FunctionSpace(mesh_m, degree, (2,))
    Vi = FunctionSpace(mesh_i, degree, (2,))

    # matrix: softer, linear hardening; inclusion: stiffer, Voce hardening
    mat_m = Material(vonMisesIsotropicHardening(LinearElasticIsotropic(70e3, 0.3), LinearHardening(200.0, 1000.0)),
                     device=device)
    mat_i = Material(vonMisesIsotropicHardening(LinearElasticIsotropic(90e3, 0.25),
                                                VoceHardening(200.0, 300.0, 10.0)), device=device)
    qm = QuadratureMap(Vm, 2 * degree, mat_m)
    qm.register_gradient("Strain", mandel_strain_2d())
    qi = QuadratureMap(Vi, 2 * degree, mat_i)
    qi.register_gradient("Strain", mandel_strain_2d())

    left = locate_dofs_geometrical(Vm, lambda x: np.isclose(x[:, 0], 0.0), 0)
    botm = locate_dofs_geometrical(Vm, lambda x: np.isclose(x[:, 1], 0.0), 1)
    boti = locate_dofs_geometrical(Vi, lambda x: np.isclose(x[:, 1], 0.0), 1)
    p_m = NonlinearMaterialProblem(qm, Function(Vm), bcs=[DirichletBC(left, 0.0), DirichletBC(botm, 0.0)],
                                   options={"ksp_type": "lu"})

    def right(x):
        return np.isclose(x[:, 0], 1.0)

    bcs_i = [DirichletBC(boti, 0.0)]
    if pull is None:
        F_i = assemble_traction(Vi, right, np.array([S_LOAD, 0.0]))
    else:
        F_i = None
        bcs_i.append(DirichletBC(locate_dofs_geometrical(Vi, right, 0), pull))
    p_i = NonlinearMaterialProblem(qi, Function(Vi), bcs=bcs_i, external_force=F_i, options={"ksp_type": "lu"})
    dom = InterfaceDomain(Vm, Vi, interface_facets(parent, cells_m, cells_i), vmap_m, vmap_i)
    blocked = BlockedNonlinearProblem([p_m, p_i], interfaces=[InterfaceTerm(0, 1, dom, elastic_interface(K_INTERFACE))],
                                      options={"ksp_type": "lu"})
    start = np.concatenate([np.stack([(pull or 0.0) * V.node_coords[:, 0], np.zeros(V.num_nodes)], 1).reshape(-1)
                            for V in (Vm, Vi)])
    return dict(blocked=blocked, problems=(p_m, p_i), materials=(mat_m, mat_i), qmaps=(qm, qi), interface=dom,
                spaces=(Vm, Vi), start=start)


def main(nx=20, ny=10, degree=1, device=None):
    """Solve the demo's blocked problem; returns ``(its, p_max_m, jump)`` as
    the JAX demo's ``main`` does: Newton iterations, the matrix's largest
    plastic strain and the interface jump (nf, nq, 2) as numpy."""
    b = build(nx, ny, degree, device)
    blocked, (p_m, p_i), (mat_m, mat_i) = b["blocked"], b["problems"], b["materials"]
    blocked.verbose = True
    ok, its = blocked.solve()
    if not ok:
        raise RuntimeError("blocked interface solve did not converge")
    p_max_m = float(mat_m.data_manager.s0["p"].max())
    p_max_i = float(mat_i.data_manager.s0["p"].max())
    if p_max_m <= 1e-4:
        raise RuntimeError(f"the matrix did not yield (p max {p_max_m:.3e})")
    jump = b["interface"].jump(p_m.u.x, p_i.u.x).cpu().numpy()
    print(f"converged in {its} Newton its (device: {mat_m.device})")
    print(f"matrix p_max = {p_max_m:.4f} (plastic), inclusion p_max = {p_max_i:.4f}")
    print(f"interface jump_x: mean {jump[..., 0].mean():.3e}, max {jump[..., 0].max():.3e}")
    print(f"|u| max: matrix {np.abs(p_m.u.x).max():.3e}, inclusion {np.abs(p_i.u.x).max():.3e}")
    return its, p_max_m, jump


if __name__ == "__main__":
    main(device="cpu" if "cpu" in sys.argv[1:] else None)
