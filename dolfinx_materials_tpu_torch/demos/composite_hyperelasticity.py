"""The composite benchmark: a unit cube of Ogden matrix with eight
quasi-rigid Saint Venant-Kirchhoff inclusions (spheres of radius 0.4 at the
corners, E_pen = 1e12, nu = 0), P2 tets with quadrature degree 2, left face
clamped, right face driven to 20 % strain in 10 uniform steps: the problem
of the upstream hyperelasticity timing study, on the analytic O-grid mesh of
``fem/composite_mesh.py`` (reordered for the banded plans).

The fused step runs ``precision="mixed"`` (f64 residuals, the
deformation-gradient tangent and CG in f32 on the symmetrically scaled
operator) with rigid-body coarse modes kept per material
(``agg_split_materials``; matrix first, so interface nodes join the
inclusions' aggregates), rtol 1e-4 and cg_rtol 1e-3, each step from the
secant predictor.

Run: ``python -m dolfinx_materials_tpu_torch.demos.composite_hyperelasticity
[coarse|fine] [cpu]``; coarse is cfg (2, 1, 3), ~2,700 tets.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from .. import Material, NonlinearMaterialProblem, QuadratureMap
from ..fem import DirichletBC, Function, FunctionSpace, locate_dofs_geometrical
from ..fem.bc import combine_bcs
from ..fem.composite_mesh import create_inclusion_cube
from ..fem.forms import deformation_gradient_3d
from ..fem.reorder import reorder_mesh
from ..models import Ogden, SaintVenantKirchhoff
from ..parallel import device_mesh, make_sharded_newton_step_general
from .ogden_block import OGDEN_PARAMS

E_PEN = 1e12
CONFIGS = {"coarse": (2, 1, 3), "fine": (3, 1, 3)}


def build(cfg=(2, 1, 3), E_pen=E_PEN, device=None, options=None):
    """``(mesh, V, materials, qmaps, bcs, bc_rx, problem)`` of the composite
    at O-grid resolution ``cfg`` (float64)."""
    mesh, tags = create_inclusion_cube(*cfg)
    mesh = reorder_mesh(mesh)
    tags = tags[mesh.cell_order]
    V = FunctionSpace(mesh, degree=2, shape=(3,))
    cells = np.arange(mesh.num_cells)
    mats, qmaps = [], []
    for beh, sub in ((Ogden(**OGDEN_PARAMS), cells[tags == 1]),
                     (SaintVenantKirchhoff(E_pen, 0.0), cells[tags == 2])):
        m = Material(beh, dtype=torch.float64, device=device)
        q = QuadratureMap(V, 2, m, cells=sub)
        q.register_gradient("F", deformation_gradient_3d())
        mats.append(m)
        qmaps.append(q)
    left = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
    right = [locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0), c) for c in range(3)]
    bc_rx = DirichletBC(right[0], 0.0)
    bcs = [DirichletBC(left, 0.0), bc_rx, DirichletBC(right[1], 0.0), DirichletBC(right[2], 0.0)]
    prob = NonlinearMaterialProblem(qmaps, Function(V), bcs=bcs, options=options)
    return mesh, V, mats, qmaps, bcs, bc_rx, prob


def make_protocol(cfg=(2, 1, 3), n_newton=25, n_cg=50, rtol=1e-4, cg_rtol=1e-3, n_steps=10, exx_max=0.2,
                  device=None):
    """The problem, its mixed fused step and the loads: ``dict(step, V,
    mask, loads, states, ...)``."""
    mesh, V, mats, qmaps, bcs, bc_rx, prob = build(cfg, device=device)
    step, _ = make_sharded_newton_step_general(
        prob, device_mesh(1, devices=[prob.device]), n_newton=n_newton, n_cg=n_cg, rtol=rtol,
        cg_rtol=cg_rtol, precision="mixed", coarse_modes="rbm", agg_split_materials=True, return_info=True)
    mask, _ = combine_bcs(bcs, V.num_dofs)
    loads = []
    for exx in np.linspace(0, exx_max, n_steps + 1)[1:]:
        bc_rx.set(float(exx))
        loads.append(combine_bcs(bcs, V.num_dofs)[1])
    return dict(step=step, V=V, mask=mask, loads=loads, states=[m.data_manager.s0.internal for m in mats],
                qmaps=qmaps, mesh=mesh, device=prob.device)


def run_steps(proto, n_steps=None, predictor=True):
    """The first ``n_steps`` load steps (all by default) from u = 0:
    ``(u, stats)``, per step ``dict(res, res0, newton, cg)``."""
    step = proto["step"]
    u = torch.zeros(proto["V"].num_dofs, dtype=torch.float64, device=proto["device"])
    u_prev, sts, stats = u, proto["states"], []
    for vals in proto["loads"][:n_steps]:
        guess = u + (u - u_prev) if predictor else u
        un, sts, rn, rn0 = step(guess, sts, proto["mask"], vals, 0.0)
        stats.append(dict(res=float(rn), res0=float(rn0), newton=int(step.info["newton"]),
                          cg=int(step.info["cg"])))
        u_prev, u = u, un
    return u, stats


def run_10_steps(cfg=(2, 1, 3), runs=2, device=None, **opts):
    """``(u, wall seconds of each run, per-step stats of the last)``; the
    first run pays the lazy set-up (kernel builds, graph captures)."""
    proto = make_protocol(cfg, device=device, **opts)
    seconds = []
    for _ in range(runs):
        if proto["device"].type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        u, stats = run_steps(proto)
        if proto["device"].type == "cuda":
            torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
    return u, seconds, stats


def host_check(cfg=(1, 1, 2), n_steps=3, exx_max=0.06, device=None):
    """The relative max difference of the fused mixed step's u from the host
    path's f64 solve (direct LU) of the same steps; small sizes only."""
    *_, bc_rx, prob = build(cfg, device=device, options=dict(ksp_type="lu"))
    for exx in np.linspace(0, exx_max, n_steps + 1)[1:]:
        bc_rx.set(float(exx))
        conv, _ = prob.solve()
        if not conv:
            raise RuntimeError("host composite solve did not converge")
    u_host = np.asarray(prob.u.x)
    proto = make_protocol(cfg, n_newton=30, n_cg=300, rtol=1e-10, cg_rtol=1e-3, n_steps=n_steps,
                          exx_max=exx_max, device=device)
    u, _ = run_steps(proto, predictor=False)
    return float(np.abs(u.cpu().numpy() - u_host).max() / np.abs(u_host).max())


def main(cfg=(2, 1, 3), device=None):
    u, seconds, stats = run_10_steps(cfg, device=device)
    print(f"composite cfg={cfg}: {u.numel()} dofs; runs {', '.join(f'{s:.2f}' for s in seconds)} s")
    for k, s in enumerate(stats):
        print(f"  step {k + 1}: rel |R| {s['res'] / max(s['res0'], 1e-300):.2e}, Newton {s['newton']}, "
              f"CG {s['cg']}")


if __name__ == "__main__":
    main(CONFIGS["fine" if "fine" in sys.argv else "coarse"], device="cpu" if "cpu" in sys.argv else None)
