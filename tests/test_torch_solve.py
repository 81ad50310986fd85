"""The port's load steps against the JAX package, in float64 on the CPU.

- the README quickstart (16x16 P2, 9 steps);
- a start from a non-zero plastic state carried over from the JAX package;
- (test_torch_solve_plate.py) the J2 plate of demos/plane_elastoplasticity.py
  on 16x32 P2 quads, where the port takes the banded route, 3 steps.

Displacement and plastic strain agree to 1e-8 relative and Newton counts are
equal: both run the same Newton/CG/line-search algorithm, and their sums
differ only in order.
"""

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
from dolfinx_materials_tpu_torch.state import from_reference_state  # noqa: E402

# one intra-op thread: the suite runs several pytest workers on one machine,
# and spinning thread pools in each of them starve one another
torch.set_num_threads(1)

RTOL = 1e-8
PKGS = {
    "torch": (tdm, tfem, tmodels, tforms, dict(device="cpu")),
    "jax": (jdm, jfem, jmodels, jforms, {}),
}


def j2_material(which):
    pkg, _, models, _, kw = PKGS[which]
    return pkg.Material(models.vonMisesIsotropicHardening(
        models.LinearElasticIsotropic(E=70e3, nu=0.3),
        models.VoceHardening(sig0=350.0, sigu=500.0, b=1e3)), **kw)


def quickstart(which, n=16, options=None):
    """README quickstart: unit square, symmetry BCs, pulled in x."""
    pkg, fem, _, forms, _ = PKGS[which]
    V = fem.FunctionSpace(fem.create_unit_square(n, n, "quad"), degree=2, shape=(2,))
    qmap = pkg.QuadratureMap(V, 4, j2_material(which))
    qmap.register_gradient("Strain", forms.mandel_strain_2d())
    bot = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), component=1)
    left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), component=0)
    pull = fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0), 0.0)
    prob = pkg.NonlinearMaterialProblem(
        qmap, fem.Function(V), bcs=[fem.DirichletBC(left, 0.0), fem.DirichletBC(bot, 0.0), pull],
        options=options)
    return prob, qmap, pull


def run(prob, qmap, bc, loads):
    its = []
    for load in loads:
        bc.set(load)
        converged, n = prob.solve()
        assert converged, load
        its.append(n)
    return np.asarray(prob.u.x), np.asarray(qmap.field_array("p")).ravel(), its


def assert_same_run(t, j):
    (ut, pt, it), (uj, pj, ij) = t, j
    assert it == ij
    assert pj.max() > 0, "the run must reach the plastic range"
    np.testing.assert_allclose(ut, uj, rtol=0, atol=RTOL * np.abs(uj).max())
    np.testing.assert_allclose(pt, pj, rtol=0, atol=RTOL * np.abs(pj).max())


def test_quickstart_matches_jax():
    loads = np.linspace(0, 0.02, 10)[1:]
    assert_same_run(run(*quickstart("torch"), loads), run(*quickstart("jax"), loads))


def test_start_from_carried_plastic_state():
    """Two steps in the JAX package; its committed state is carried into the
    port, and one more step runs in both from zero displacement. (From the
    converged displacement, the points that yielded sit on the yield surface,
    where rounding picks the tangent's branch in each package.)"""
    opts = dict(predictor=False)
    jp = quickstart("jax", n=8, options=opts)
    run(*jp, (0.006, 0.012))
    state = jp[1].material.get_initial_state_dict()
    assert state["p"].max() > 1e-3

    tp = quickstart("torch", n=8, options=opts)
    tp[1].material.set_initial_state_dict(from_reference_state(state, device="cpu"))
    s0 = tp[1].material.data_manager.s0
    np.testing.assert_array_equal(s0["eps_p"].numpy(), state["eps_p"])
    assert s0["p"].dtype == torch.float64
    jp[0].u.x = np.zeros_like(jp[0].u.x)
    assert_same_run(run(*tp, (0.018,)), run(*jp, (0.018,)))
