"""Adaptive load stepping with cut-backs (``solve_adaptive``) and the solver's
metrics: tests/test_adaptive.py's two cases, run in the port and in the JAX
package on the same problem, in float64 on the CPU. Both packages run the
same Newton with a host LU solve, so they accept the same loads; the states
agree to 1e-8 of their scale."""

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
from dolfinx_materials_tpu_torch.utils import reset_timings, timing  # noqa: E402

torch.set_num_threads(1)

E, SIG0 = 70e3, 350.0
PKGS = {"torch": (tdm, tfem, tmodels, tforms, dict(device="cpu")), "jax": (jdm, jfem, jmodels, jforms, {})}


def make_problem(which, behavior, N, gradient, max_it):
    """The uniaxial plate of tests/test_adaptive.py: N x N P1 quads, left
    u_x = 0, bottom u_y = 0, the right edge's u_x set by the returned BC."""
    pkg, fem, models, forms, kw = PKGS[which]
    V = fem.FunctionSpace(fem.create_unit_square(N, N, "quad"), 1, (2,))
    mat = pkg.Material(behavior(models), **kw)
    q = pkg.QuadratureMap(V, 2, mat)
    q.register_gradient(*gradient(forms))
    loc = fem.locate_dofs_geometrical
    bc = fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 1), 0), 0.0)
    bcs = [fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 0], 0), 0), 0.0),
           fem.DirichletBC(loc(V, lambda x: np.isclose(x[:, 1], 0), 1), 0.0), bc]
    prob = pkg.NonlinearMaterialProblem(q, fem.Function(V), bcs=bcs, options={"ksp_type": "lu", "max_it": max_it})
    return prob, bc, mat, q


def j2_voce(m):
    return m.vonMisesIsotropicHardening(m.LinearElasticIsotropic(E, 0.3), m.VoceHardening(SIG0, 500.0, 1e3))


def fefp_voce(m):
    return m.FeFpJ2Plasticity(m.LinearElasticIsotropic(E, 0.3), m.VoceHardening(SIG0, 500.0, 1e2))


def strain(forms):
    return "Strain", forms.mandel_strain_2d()


def def_grad(forms):
    return "F", forms.deformation_gradient_2d()


def test_adaptive_cutback_succeeds_where_single_step_fails():
    """8 sig0/E in one step fails within 5 Newton iterations; solve_adaptive
    from 2 steps reaches it with the same budget, accepting the JAX
    package's loads; p to 1e-8 of its scale; the metrics and the timers of
    the hot phases are recorded."""
    exx_end = 8 * SIG0 / E
    prob, bc, _, q = make_problem("torch", j2_voce, 4, strain, 5)
    bc.set(exx_end)
    assert not prob.solve()[0]
    q.revert()
    out = {}
    reset_timings()
    for which in ("torch", "jax"):
        prob, bc, mat, q = make_problem(which, j2_voce, 4, strain, 5)
        accepted = PKGS[which][0].solve_adaptive(prob, bc.set, exx_end, nsteps0=2)
        out[which] = (list(accepted), np.asarray(mat.data_manager.s0["p"]).ravel(), prob, q)
    (acc, p, prob, q), (acc_j, p_j, _, _) = out["torch"], out["jax"]
    assert np.isclose(acc[-1], exx_end) and len(acc) >= 2
    np.testing.assert_allclose(acc, acc_j, rtol=1e-12)
    assert p.max() > 1e-3
    np.testing.assert_allclose(p, p_j, rtol=0, atol=1e-8 * p_j.max())
    m = prob.metrics
    assert m["converged"] and m["newton_iterations"] <= 5 and m["gauss_points"] == q.num_points
    assert m["residual_history"][-1] < m["residual_history"][0]
    for label in ("qmap: material integration", "solver: Newton solve"):
        count, total = timing(label)
        assert count > 0 and total > 0


def test_adaptive_cutback_fefp_envelope_guard():
    """FeFp on 3x3 quads pulled to a 12 % stretch from 2 steps with at most
    8 Newton iterations each: the line search and the cut-backs recover from
    trial states outside the whole-batch update's envelope; the same loads
    as the JAX package, p finite, above 0.02 and to 1e-8 of its scale."""
    out = {}
    for which in ("torch", "jax"):
        prob, bc, mat, _ = make_problem(which, fefp_voce, 3, def_grad, 8)
        assert mat._fast_update is not None
        accepted = PKGS[which][0].solve_adaptive(prob, bc.set, 0.12, nsteps0=2)
        out[which] = (list(accepted), np.asarray(mat.data_manager.s0["p"]).ravel())
    (acc, p), (acc_j, p_j) = out["torch"], out["jax"]
    assert len(acc) >= 2 and np.isclose(acc[-1], 0.12)
    np.testing.assert_allclose(acc, acc_j, rtol=1e-12)
    assert np.isfinite(p).all() and p.max() > 0.02
    np.testing.assert_allclose(p, p_j, rtol=0, atol=1e-8 * p_j.max())
