"""The program's plate: the plane-strain J2 plate of the port's
``demos/plane_elastoplasticity.py`` (bottom clamped, top pulled in y), P2
quadrilaterals, von Mises with Voce hardening, and its fused load step
(``parallel.make_sharded_newton_step_general``)."""

from types import SimpleNamespace

import numpy as np


def build(cfg, device):
    import torch

    import dolfinx_materials_tpu_torch as dm
    from dolfinx_materials_tpu_torch import fem
    from dolfinx_materials_tpu_torch.fem.forms import mandel_strain_2d
    from dolfinx_materials_tpu_torch.models import LinearElasticIsotropic, VoceHardening, vonMisesIsotropicHardening
    from dolfinx_materials_tpu_torch.parallel import device_mesh, make_sharded_newton_step_general

    dtype = getattr(torch, cfg["dtype"])
    lx, ly = cfg["lx"], cfg["ly"]
    mesh = fem.create_rectangle((0.0, 0.0), (lx, ly), (cfg["nx"], cfg["ny"]), "quad")
    V = fem.FunctionSpace(mesh, degree=cfg["degree"], shape=(2,))
    behavior = vonMisesIsotropicHardening(LinearElasticIsotropic(cfg["E"], cfg["nu"]),
                                          VoceHardening(cfg["sig0"], cfg["sigu"], cfg["b"]))
    material = dm.Material(behavior, dtype=dtype, device=device)
    qmap = dm.QuadratureMap(V, cfg["quadrature_degree"], material)
    qmap.register_gradient("Strain", mandel_strain_2d())
    bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
    top_y = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], ly), 1)
    bc_top = fem.DirichletBC(top_y, 0.0)
    problem = dm.NonlinearMaterialProblem(qmap, fem.Function(V), bcs=[fem.DirichletBC(bottom, 0.0), bc_top])
    mesh_ = device_mesh(1, devices=[device])
    step, pad = make_sharded_newton_step_general(problem, mesh_, return_info="stats", **cfg["fused_step"])
    return SimpleNamespace(
        problem=problem, qmap=qmap, bc_top=bc_top, step=step, dtype=dtype, ndofs=V.num_dofs,
        virgin=pad([material.data_manager.s0.internal]),
        y=torch.as_tensor(V.node_coords[:, 1], dtype=dtype, device=device),
        node_coords=np.asarray(V.node_coords), x_q=qmap.domain.x_q.reshape(-1, 2).cpu().numpy(),
        shapes=dict(ne=qmap.domain.ne, ndof_el=qmap.domain.ndof_el, ndofs=V.num_dofs, nnodes=V.num_dofs // 2,
                    ncomp=2, nmodes=2, ncoarse=2 * cfg["fused_step"]["pc_boxes"] ** 2, dtype=cfg["dtype"]),
    )
