"""The 3D Ogden block: 10 uniform load steps to 20 % compression of a unit
cube (bottom clamped, top face pushed down in z), the protocol of the
upstream hyperelasticity timing study, with its MFront Ogden parameters
(mu_mfront = 27778, alpha = 28.8, K = 69444444; here mu = mu_mfront alpha /
2, K verbatim). Two discretizations:

- ``tetrahedron``, degree 2 (the study's own P2 tets, degree-4 quadrature):
  ``precision="mixed"`` through the general fused step, f64 residuals, the
  deformation-gradient tangent and CG in f32 on the scaled operator, the
  P2 -> P1 coarse space, rtol 1e-4, cg_rtol 1e-3; the tet dofmap routes the
  gathers, assembly and SpMV through the banded plans (K4 ``cell``/``fm``,
  K3 ``asm``);
- ``hexahedron``, degree 1: float32 through ``make_sharded_newton_step`` and
  the 3D stencil, rtol 2e-5.

Each step starts from the secant predictor ``u + (u - u_prev)``, in a Python
loop over the fused step.

Run: ``python -m dolfinx_materials_tpu_torch.demos.ogden_block [N] [tet]
[cpu]`` (N = 10 tet is the study's "fine" size, 6,000 tets; N = 19 hex).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, create_unit_cube, locate_dofs_geometrical
from ..fem.bc import combine_bcs
from ..fem.forms import deformation_gradient_3d
from ..models import Ogden
from ..parallel import device_mesh, make_sharded_newton_step, make_sharded_newton_step_general

#: the MFront Ogden parameters in this package's convention
OGDEN_PARAMS = dict(mu=(27778.0 * 28.8 / 2.0,), alpha=(28.8,), K=69444444.0)


def build(N, cell_type="hexahedron", degree=1, dtype=torch.float32, device=None):
    """``(material, qmap, V, bcs, bc_top)`` of the block at N^3 cells (6 tets
    a cube for ``tetrahedron``), quadrature degree 2 * degree."""
    mat = Material(Ogden(**OGDEN_PARAMS), dtype=dtype, device=device)
    V = FunctionSpace(create_unit_cube(N, N, N, cell_type), degree=degree, shape=(3,))
    qmap = QuadratureMap(V, 2 * degree, mat)
    qmap.register_gradient("F", deformation_gradient_3d())
    bottom = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 2], 0.0))
    bc_top = DirichletBC(locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 2], 1.0), 2), 0.0)
    return mat, qmap, V, [DirichletBC(bottom, 0.0), bc_top], bc_top


def make_protocol(N, cell_type="hexahedron", degree=1, precision="f32", n_newton=20, n_cg=150, rtol=None,
                  cg_rtol=None, coarse_modes="p1", device=None):
    """Build the problem and its fused step: ``dict(step, V, mask, loads,
    state, mixed, qmap)``; ``loads`` are the 10 prescribed-value vectors."""
    mixed = precision == "mixed"
    dtype = torch.float64 if mixed else torch.float32
    mat, qmap, V, bcs, bc_top = build(N, cell_type, degree, dtype, device)
    prob = NonlinearMaterialProblem(qmap, Function(V), bcs=bcs)
    mesh = device_mesh(1, devices=[prob.device])
    if mixed:
        step, _ = make_sharded_newton_step_general(
            prob, mesh, n_newton=n_newton, n_cg=n_cg, rtol=1e-4 if rtol is None else rtol,
            cg_rtol=1e-3 if cg_rtol is None else cg_rtol, precision="mixed", coarse_modes=coarse_modes,
            return_info=True)
    else:
        step, _ = make_sharded_newton_step(qmap, prob, mesh, n_newton=n_newton, n_cg=n_cg,
                                           rtol=2e-5 if rtol is None else rtol)
    mask, _ = combine_bcs(bcs, V.num_dofs)
    loads = []
    for ez in np.linspace(0, 0.2, 11)[1:]:
        bc_top.set(-float(ez))
        loads.append(combine_bcs(bcs, V.num_dofs)[1])
    return dict(step=step, V=V, mask=mask, loads=loads, state=mat.data_manager.s0.internal, mixed=mixed,
                qmap=qmap, dtype=dtype, device=prob.device)


def run_steps(proto, n_steps=10, lift_first=False):
    """The load steps from u = 0 with the secant predictor: ``(u, stats)``,
    stats per step ``dict(res, res0, newton, cg)`` (``res0`` the residual
    Newton measured against).

    ``lift_first`` starts the first step from the uniform compression u_z =
    -0.02 z instead of u = 0 with the top face moved. From that start the
    P2 interpolation puts the whole increment into the top layer of cells,
    with dF_zz = -0.06 N at the face: from N = 17 on it inverts those
    cells."""
    step, mixed = proto["step"], proto["mixed"]
    u = torch.zeros(proto["V"].num_dofs, dtype=proto["dtype"], device=proto["device"])
    u_prev, st, stats = u, proto["state"], []
    for k, vals in enumerate(proto["loads"][:n_steps]):
        guess = u + (u - u_prev)
        if k == 0 and lift_first:
            z = torch.as_tensor(proto["V"].node_coords[:, 2], dtype=u.dtype, device=u.device)
            guess = torch.stack([torch.zeros_like(z), torch.zeros_like(z), -0.02 * z], dim=1).reshape(-1)
        if mixed:
            un, sts, rn, rn0 = step(guess, [st], proto["mask"], vals, 0.0)
            st = sts[0]
        else:
            un, st, rn = step(guess, st, proto["mask"], vals, 0.0)
            rn0 = step.info["res0"]
        info = step.info
        stats.append(dict(res=float(rn), res0=float(rn0), newton=int(info["newton"]), cg=int(info["cg"])))
        u_prev, u = u, un
    return u, stats


def run_10_steps(N, cell_type="hexahedron", degree=1, precision="f32", runs=2, n_steps=10, device=None,
                 **opts):
    """Build the protocol, run its steps ``runs`` times (the first pays the
    lazy set-up: kernel builds, CUDA-graph captures) and return ``(u, wall
    seconds of each run, per-step stats of the last)``."""
    proto = make_protocol(N, cell_type, degree, precision, device=device, **opts)
    seconds = []
    for _ in range(runs):
        if proto["device"].type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, stats = run_steps(proto, n_steps)
        if proto["device"].type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return u, seconds, stats


def main(N=10, tet=True, device=None):
    cell, deg, prec = ("tetrahedron", 2, "mixed") if tet else ("hexahedron", 1, "f32")
    u, seconds, stats = run_10_steps(N, cell, deg, prec, device=device)
    print(f"N={N} {cell} P{deg} {prec}: {u.numel()} dofs; runs {', '.join(f'{s:.2f}' for s in seconds)} s")
    for k, s in enumerate(stats):
        print(f"  step {k + 1}: rel |R| {s['res'] / max(s['res0'], 1e-300):.2e}, Newton {s['newton']}, "
              f"CG {s['cg']}")


if __name__ == "__main__":
    args = sys.argv[1:]
    ints = [int(a) for a in args if a.isdigit()]
    main(ints[0] if ints else 10, tet="tet" in args or "hex" not in args,
         device="cpu" if "cpu" in args else None)
