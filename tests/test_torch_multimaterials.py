"""Cell-subset quadrature maps (tests/test_multimaterials.py) in the port,
against its own one-map solve and the JAX package's, in float64 on the CPU:
two subset maps reproduce the single map's solution, and a soft and a hard
half stretch as springs in series."""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402

torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0
PKGS = {"torch": (tdm, tfem, tmodels, tforms, dict(device="cpu")), "jax": (jdm, jfem, jmodels, jforms, {})}


def solve(which, behaviors, subsets, exx):
    """The 4x4 P1 plate with one map per (behavior, cell subset) (``None``:
    every cell), pulled to u_x = exx under a host LU Newton: ``(u, states,
    V)``."""
    pkg, fem, models, forms, kw = PKGS[which]
    V = fem.FunctionSpace(fem.create_unit_square(4, 4, "quad"), 1, (2,))
    mats, qmaps = [], []
    for beh, cells in zip(behaviors, subsets):
        m = pkg.Material(beh(models), **kw)
        q = pkg.QuadratureMap(V, 2, m, cells=cells)
        q.register_gradient("Strain", forms.mandel_strain_2d())
        mats.append(m)
        qmaps.append(q)
    loc = fem.locate_dofs_geometrical
    bcs = [fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 0), 0), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 1], 0), 1), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 1), 0), exx)]
    u = fem.Function(V)
    assert pkg.NonlinearMaterialProblem(qmaps, u, bcs=bcs, options={"ksp_type": "lu"}).solve()[0]
    return u.x.copy(), [m.data_manager.s0 for m in mats], V


def j2_linear(m):
    return m.vonMisesIsotropicHardening(m.LinearElasticIsotropic(E, NU), m.LinearHardening(SIG0, 1000.0))


def test_split_equals_mono():
    """Even and odd cells as two maps against one map over all cells, at
    u_x = 3 sig0/E: u to rtol 1e-9 / atol 1e-13 and each subset's p to rtol
    1e-8 / atol 1e-14 of the one map's (the JAX test's tolerances); the
    split solve to 1e-8 of the JAX package's."""
    cells = np.arange(16)
    subsets = [cells[cells % 2 == 0], cells[cells % 2 == 1]]
    exx = 3 * SIG0 / E
    u0, (s0,), _ = solve("torch", [j2_linear], [None], exx)
    u1, states, _ = solve("torch", [j2_linear] * 2, subsets, exx)
    np.testing.assert_allclose(u1, u0, rtol=1e-9, atol=1e-13)
    p0 = np.asarray(s0["p"]).ravel()
    assert p0.max() > 1e-4
    for sub, st in zip(subsets, states):
        idx = (sub[:, None] * 4 + np.arange(4)[None, :]).ravel()
        np.testing.assert_allclose(np.asarray(st["p"]).ravel(), p0[idx], rtol=1e-8, atol=1e-14)
    uj, _, _ = solve("jax", [j2_linear] * 2, subsets, exx)
    np.testing.assert_allclose(u1, uj, rtol=0, atol=1e-8 * np.abs(uj).max())


def test_heterogeneous_materials():
    """A soft (E/10) left half and a hard right half at u_x = 1e-3: the
    mid-line stretches to 10/11 of the load within 5 % (the JAX test's 1D
    estimate), and u equals the JAX package's to 1e-8 of its scale."""
    mesh = tfem.create_unit_square(4, 4, "quad")
    centers = mesh.cell_centers()
    subsets = [np.nonzero(centers[:, 0] < 0.5)[0], np.nonzero(centers[:, 0] >= 0.5)[0]]
    behaviors = [lambda m: m.LinearElasticIsotropic(E / 10, NU), lambda m: m.LinearElasticIsotropic(E, NU)]
    u, _, V = solve("torch", behaviors, subsets, 1e-3)
    mid_x = u[::2][np.isclose(V.node_coords[:, 0], 0.5)]
    np.testing.assert_allclose(mid_x.mean(), 1e-3 * 10.0 / 11.0, rtol=5e-2)
    assert mid_x.mean() > 0.75e-3
    uj, _, _ = solve("jax", behaviors, subsets, 1e-3)
    np.testing.assert_allclose(u, uj, rtol=0, atol=1e-8 * np.abs(uj).max())
