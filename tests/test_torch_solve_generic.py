"""Behaviors with no whole-batch fast path through the FEM entry points
(``QuadratureMap.update`` -> ``NonlinearMaterialProblem.solve``) of the port
and of the JAX package, in float64 on the CPU.

The uniaxial-tension harness of tests/uniaxial_tension.py, written here once
for both packages: unit square, plane-strain Mandel strain, left u_x = 0,
bottom u_y = 0, right u_x stepped; it returns the stress history at the first
Gauss point. Stress histories agree to 1e-8 of their scale (both packages run
the same Newton with a host LU solve; their sums differ only in order), and
Newton counts are equal where the start is off the yield surface (from a
converged plastic state rounding picks the tangent's branch in each package;
ROADMAP.md Queue 3).
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402

torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0
PKGS = {
    "torch": (tdm, tfem, tmodels, tforms, dict(device="cpu")),
    "jax": (jdm, jfem, jmodels, jforms, {}),
}


def uniaxial_tension_2D(which, behavior, Exx, N=1, order=1, cell_type="quad", angle=None, dt=0.0):
    """``(stress history (len(Exx), 6), Newton counts, qmap)`` of the harness
    in package ``which`` for ``behavior(models)``."""
    pkg, fem, models, forms, kw = PKGS[which]
    material = pkg.Material(behavior(models), **kw)
    mesh = fem.create_unit_square(N, N, cell_type)
    V = fem.FunctionSpace(mesh, degree=order, shape=(2,))
    left_x = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0), component=0)
    bottom_y = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0), component=1)
    right_x = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0), component=0)
    bc_right = fem.DirichletBC(right_x, 0.0)
    bcs = [fem.DirichletBC(left_x, 0.0), fem.DirichletBC(bottom_y, 0.0), bc_right]
    qmap = pkg.QuadratureMap(V, 2 * order, material)
    qmap.dt = dt
    qmap.register_gradient(material.gradient_names[0], forms.mandel_strain_2d())
    if angle is not None:
        c, s = np.cos(angle), np.sin(angle)
        material.rotation_matrix = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    problem = pkg.NonlinearMaterialProblem(
        qmap, fem.Function(V), bcs=bcs, options={"ksp_type": "lu", "atol": 1e-10, "rtol": 1e-10}
    )
    stress = np.zeros((len(Exx), 6))
    newton = []
    for i, exx in enumerate(Exx[1:]):
        bc_right.set(exx)
        converged, it = problem.solve()
        assert converged, f"{which}: Newton failed at step {i + 1}"
        newton.append(it)
        stress[i + 1] = np.asarray(material.data_manager.s0[material.flux_names[0]])[0]
    return stress, newton, qmap


def norton(m):
    return m.NortonViscoplasticity(m.LinearElasticIsotropic(E, NU), m.LinearHardening(100.0, 1e3), K=150.0, n=3.0)


def zener(m):
    return m.ZenerViscoelasticity(50e3, 10e3, 20e3, 0.5)


def plane_stress_j2(m):
    return m.PlaneStress(m.vonMisesIsotropicHardening(
        m.LinearElasticIsotropic(E, NU), m.LinearHardening(SIG0, 1000.0)))


def orthotropic(m):
    return m.LinearElasticOrthotropic(100e3, 10e3, 10e3, 0.3, 0.3, 0.3, 5e3, 5e3, 4e3)


#: name -> (behavior, strain history, harness options, equal Newton counts?)
RUNS = {
    # rate-dependent: no yield surface to sit on, counts are comparable
    "norton": (norton, np.linspace(0, 8e-3, 6), dict(N=2, dt=0.05), True),
    "zener": (zener, np.array([0.0, 2e-3, 2e-3, 2e-3, 4e-3]), dict(N=2, dt=0.25, cell_type="triangle"), True),
    # later steps start on the yield surface: histories only
    "plane_stress_j2": (plane_stress_j2, np.linspace(0, 10 * SIG0 / E, 8), dict(N=1), False),
    "rotated_orthotropic": (orthotropic, np.array([0.0, 1e-3, 2e-3]), dict(N=2, order=2, angle=0.6), True),
}


@pytest.mark.parametrize("name", sorted(RUNS))
def test_uniaxial_history_matches_jax(name):
    behavior, Exx, kw, same_counts = RUNS[name]
    s_t, n_t, q_t = uniaxial_tension_2D("torch", behavior, Exx, **kw)
    s_j, n_j, q_j = uniaxial_tension_2D("jax", behavior, Exx, **kw)
    scale = np.abs(s_j).max()
    assert scale > 10.0
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-8 * scale)
    if same_counts:
        assert n_t == n_j
    for field in q_t.material.internal_state_variables:
        a, b = q_t.field_array(field).numpy(), np.asarray(q_j.field_array(field))
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-10 + 1e-8 * np.abs(b).max(), err_msg=field)


def test_plane_stress_reaches_the_hardening_curve():
    """What the history means, as tests/test_hypotheses.py checks it for the
    JAX package: sig_zz stays 0 through plastic flow and the von Mises stress
    sits on the hardening curve."""
    from dolfinx_materials_tpu_torch.ops import tensors as tn

    stress, _, qmap = uniaxial_tension_2D("torch", plane_stress_j2, np.linspace(0, 10 * SIG0 / E, 8))
    sig = stress[-1]
    p = qmap.material.data_manager.s0["p"].numpy().ravel()
    assert p.max() > 1e-3
    np.testing.assert_allclose(sig[2], 0.0, atol=1e-6 * SIG0)
    np.testing.assert_allclose(float(tn.eq_vm(torch.as_tensor(sig))), SIG0 + 1000.0 * p[0], rtol=1e-6)


def test_rotation_changes_the_orthotropic_history():
    s0, _, _ = uniaxial_tension_2D("torch", orthotropic, np.array([0.0, 1e-3]), N=1)
    s1, _, _ = uniaxial_tension_2D("torch", orthotropic, np.array([0.0, 1e-3]), N=1, angle=np.pi / 2)
    assert s1[1, 0] < 0.2 * s0[1, 0]  # the soft axis now carries the pull


def lame_cylinder(which):
    """Thick cylinder, axisymmetric kinematics with the 2 pi r measure, plane
    strain in z, inner radius pushed outwards by a prescribed displacement."""
    pkg, fem, models, forms, kw = PKGS[which]
    V = fem.FunctionSpace(fem.create_rectangle((1.0, 0.0), (2.0, 0.1), (12, 1), "quad"), 1, (2,))
    mat = pkg.Material(models.LinearElasticIsotropic(E, NU), **kw)
    qmap = pkg.QuadratureMap(V, 2, mat, weight=lambda x: 2 * np.pi * x[:, 0])
    qmap.register_gradient("Strain", forms.axisymmetric_strain())
    uz = fem.locate_dofs_geometrical(V, lambda x: np.full(len(x), True), 1)
    inner = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0), 0)
    prob = pkg.NonlinearMaterialProblem(
        qmap, fem.Function(V), bcs=[fem.DirichletBC(uz, 0.0), fem.DirichletBC(inner, 1e-3)],
        options={"ksp_type": "lu"})
    converged, _ = prob.solve()
    assert converged
    return np.asarray(mat.data_manager.s0["Stress"]), np.asarray(qmap.domain.wdetJ), np.asarray(prob.u.x)


def test_axisymmetric_cylinder_matches_jax():
    s_t, w_t, u_t = lame_cylinder("torch")
    s_j, w_j, u_j = lame_cylinder("jax")
    np.testing.assert_allclose(w_t, w_j, rtol=1e-13)
    np.testing.assert_allclose(u_t, u_j, rtol=0, atol=1e-10 * np.abs(u_j).max())
    np.testing.assert_allclose(s_t, s_j, rtol=0, atol=1e-8 * np.abs(s_j).max())
    assert (s_t[:, 1] > 0).all() and (s_t[:, 0] < 0).all()  # hoop tension, radial compression
    np.testing.assert_allclose(s_t[:, 2], NU * (s_t[:, 0] + s_t[:, 1]), rtol=1e-9)


def j2_qmap(which, **kw):
    pkg, fem, models, forms, mkw = PKGS[which]
    V = fem.FunctionSpace(fem.create_unit_square(2, 2, "quad"), 1, (2,))
    mat = pkg.Material(models.vonMisesIsotropicHardening(
        models.LinearElasticIsotropic(E, NU), models.LinearHardening(SIG0, 1000.0)), **mkw)
    qmap = pkg.QuadratureMap(V, 2, mat, **kw)
    qmap.register_gradient("Strain", forms.mandel_strain_2d())
    return qmap, mat


def test_update_initial_state_scalar_array_callable():
    """tests/test_initialization.py:36-73 in the port, value by value against
    the JAX package."""
    qmap, mat = j2_qmap("torch")
    jq, jmat = j2_qmap("jax")
    n = qmap.num_points
    xq = qmap.domain.x_q.reshape(n, -1).numpy()
    np.testing.assert_allclose(xq, np.asarray(jq.domain.x_q).reshape(n, -1), rtol=1e-14)
    eps_p0 = np.zeros((n, 6))
    eps_p0[:, 3] = 1e-3
    for field, value, want in (
        ("p", 0.01, np.full((n, 1), 0.01)),
        ("p", np.linspace(0, 1, n), np.linspace(0, 1, n)[:, None]),
        ("p", lambda x: x[:, 0] * 0.5, 0.5 * xq[:, :1]),
        ("eps_p", eps_p0, eps_p0),
    ):
        qmap.update_initial_state(field, value)
        jq.update_initial_state(field, value)
        for buf, jbuf in ((mat.data_manager.s0, jmat.data_manager.s0), (mat.data_manager.s1, jmat.data_manager.s1)):
            np.testing.assert_allclose(buf[field].numpy(), want, rtol=1e-15)
            np.testing.assert_allclose(buf[field].numpy(), np.asarray(jbuf[field]), rtol=1e-15)
    # the initialized state feeds the next integrate: with p0 = 0.01 the yield
    # stress is sig0 + H * 0.01
    qmap.update_initial_state("eps_p", np.zeros((n, 6)))
    qmap.update_initial_state("p", 0.01)
    eps = np.zeros((n, 6))
    eps[:, 3] = 0.05
    sig, _, _ = mat.integrate(eps)
    from dolfinx_materials_tpu_torch.ops import tensors as tn

    p1 = mat.data_manager.s1["p"].numpy().ravel()
    np.testing.assert_allclose(tn.eq_vm(sig).numpy(), SIG0 + 1000.0 * p1, rtol=1e-9)
    assert (p1 > 0.01).all()
    np.testing.assert_allclose(qmap.flux_array("Stress").numpy(), sig.numpy())


def test_check_nans_raises_and_names_the_arrays():
    qmap, mat = j2_qmap("torch", check_nans=True)
    V = qmap.space
    u = np.zeros(V.num_dofs)
    qmap.update(u)  # finite: passes
    u[0] = np.nan
    with pytest.raises(FloatingPointError, match="non-finite flux, isv, tangent"):
        qmap.update(u)
    quiet, _ = j2_qmap("torch")
    quiet.update(u)  # off by default


def test_external_state_variable_as_expression_of_u():
    """An ESV registered as an expression is evaluated from u at every update
    and reaches the behavior; one registered as a value is passed through."""
    from dolfinx_materials_tpu_torch.models.base import SmallStrainBehavior
    from dolfinx_materials_tpu_torch.ops import tensors as tn

    class Swelling(SmallStrainBehavior):
        external_state_variables = {"Concentration": 1}

        def constitutive_update(self, inputs, state, dt):
            e = inputs["Strain"] - 0.1 * inputs["Concentration"][0] * torch.as_tensor(tn.I2)
            return {"Stress": 2.0 * e}, state

    V = tfem.FunctionSpace(tfem.create_unit_square(2, 2, "quad"), 1, (2,))
    mat = tdm.Material(Swelling(), device="cpu")
    qmap = tdm.QuadratureMap(V, 2, mat)
    qmap.register_gradient("Strain", tforms.mandel_strain_2d())
    # "concentration" read off the first displacement component
    qmap.register_external_state_variable("Concentration", tforms.scalar_value())
    u = np.random.default_rng(0).normal(size=V.num_dofs) * 1e-2
    flux, Ct = qmap.update(u)
    c = qmap.domain.make_eval(tforms.scalar_value())(torch.as_tensor(u))
    strain = qmap.domain.make_eval(tforms.mandel_strain_2d())(torch.as_tensor(u))
    want = 2.0 * (strain - 0.1 * c * torch.as_tensor(tn.I2))
    torch.testing.assert_close(flux, want, rtol=1e-13, atol=1e-15)
    torch.testing.assert_close(qmap.update_flux_only(u), want, rtol=1e-13, atol=1e-15)
    qmap2 = tdm.QuadratureMap(V, 2, tdm.Material(Swelling(), device="cpu"))
    qmap2.register_gradient("Strain", tforms.mandel_strain_2d())
    qmap2.register_external_state_variable("Concentration", 0.5)
    flux2, _ = qmap2.update(u)
    torch.testing.assert_close(flux2, 2.0 * (strain - 0.05 * torch.as_tensor(tn.I2)), rtol=1e-13, atol=1e-15)


def test_new_kinematic_expressions_match_jax():
    g = np.array([[1e-3, 4e-3], [2e-3, 3e-3]])
    got = tforms.plane_stress_strain_3()(tforms.Ctx(u=torch.zeros(2), grad=torch.as_tensor(g), x=torch.zeros(2)))
    want = jforms.plane_stress_strain_3()(jforms.Ctx(u=jnp.zeros(2), grad=jnp.asarray(g), x=jnp.zeros(2)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    ctx = dict(u=[5e-3, 0.0], grad=g, x=[2.0, 0.0])
    got = tforms.axisymmetric_strain()(tforms.Ctx(**{k: torch.as_tensor(np.asarray(v)) for k, v in ctx.items()}))
    want = jforms.axisymmetric_strain()(jforms.Ctx(**{k: jnp.asarray(v) for k, v in ctx.items()}))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-15)
    np.testing.assert_allclose(got.numpy()[[1, 4]], [5e-3 / 2.0, np.sqrt(2) * 3e-3])  # hoop strain, 13-slot shear
    got = tforms.scalar_value()(tforms.Ctx(**{k: torch.as_tensor(np.asarray(v)) for k, v in ctx.items()}))
    want = jforms.scalar_value()(jforms.Ctx(**{k: jnp.asarray(v) for k, v in ctx.items()}))
    assert got.shape == (1,) and float(got[0]) == float(want[0]) == 5e-3
