"""The port's finite-strain plasticity (``models/finite_strain.py``) against
the JAX package's, in float64 on the CPU, on inputs made from a numpy seed:

- the per-point FeFp update (``use_batched_fast=False``, the generic
  ``vmap(jacfwd)`` path) over 10 points and 20 uniaxial steps, as
  tests/test_finite_strain.py drives it: PK1, tangent and state to 1e-10 of
  their scale;
- the whole-batch path in both tangent modes, 2 steps at n = 48 with exact
  F = I points: PK1, Ct and state to 1e-12 of scale (the tolerance of
  tests/test_fefp_batched.py between its two tangent modes), and the port's
  fast path against its own per-point path to 1e-8 (that file's bar);
- ``batched_flux``, the envelope guard's NaN and the opt-out;
- Hencky around linear elasticity and around J2 against FeFp at small
  strain, with the bars of tests/test_finite_strain.py, and each against
  the JAX composition to 1e-10 (the elastic PK1 at a 1e-7 strain to 1e-7,
  see the test);
- the P2-tet bar of ``demos/finite_strain_elastoplasticity.py``'s twin at
  N = 1 for 2 load steps against the same build in the JAX package: the
  same steps, u to 1e-8.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import dolfinx_materials_tpu as jdm  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402

torch.set_num_threads(1)

E, NU = 70e3, 0.3
I9 = np.array([1.0, 1, 1, 0, 0, 0, 0, 0, 0])
NS = [0, 4, 8, 1, 3, 2, 6, 5, 7]  # row-major 3x3 -> nonsym 9-vector


def fefp(pkg, **kw):
    return pkg.FeFpJ2Plasticity(pkg.LinearElasticIsotropic(200e3, 0.3), pkg.VoceHardening(350.0, 500.0, 50.0), **kw)


def rand_Fv(rng, n, amp):
    F = np.tile(np.eye(3), (n, 1, 1)) + amp * rng.standard_normal((n, 3, 3))
    F[: n // 4] = np.eye(3)
    return F.reshape(n, 9)[:, NS]


def compose(Fv, rng, amp):
    n = Fv.shape[0]
    F = np.empty((n, 3, 3))
    F.reshape(n, 9)[:, NS] = Fv
    F = F @ (np.eye(3) + amp * rng.standard_normal((n, 3, 3)))
    return F.reshape(n, 9)[:, NS]


def close(a, b, tol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1.0))


def init_states(n):
    t = {"be": torch.tensor(np.tile([1.0, 1, 1, 0, 0, 0], (n, 1))), "p": torch.zeros(n),
         "F_prev": torch.tensor(np.tile(I9, (n, 1)))}
    return t, {k: jnp.asarray(v.numpy()) for k, v in t.items()}


def drive_uniaxial(mat, eps=2e-2, nsteps=20, nbatch=10):
    """tests/test_finite_strain.py's uniaxial loading loop, on numpy inputs."""
    mat.set_data_manager(nbatch)
    out = []
    for t in np.linspace(0, 1.0, nsteps)[1:]:
        F = np.zeros((nbatch, 9))
        F[:, 0], F[:, 1], F[:, 2] = 1 + eps * t, 1 - eps / 2 * t, 1 - eps / 2 * t
        P, _, Ct = mat.integrate(F, 0.0)
        mat.data_manager.update()
        s0 = mat.data_manager.s0
        out.append((np.asarray(P), np.asarray(Ct), np.asarray(s0["p"]), np.asarray(s0["eps_p" if "eps_p" in
                                                                                    s0.internal else "be"])))
    return out


def test_per_point_fefp_matches_jax():
    ys = lambda p: 500.0 + 250.0 * (1 - torch.exp(-1000.0 * p))  # noqa: E731
    ysj = lambda p: 500.0 + 250.0 * (1 - jnp.exp(-1000.0 * p))  # noqa: E731
    mt = tdm.Material(tmodels.FeFpJ2Plasticity(tmodels.LinearElasticIsotropic(E, NU), ys, use_batched_fast=False),
                      device="cpu")
    mj = jdm.Material(jmodels.FeFpJ2Plasticity(jmodels.LinearElasticIsotropic(E, NU), ysj, use_batched_fast=False))
    assert mt._fast_update is None and mt._fast_flux is None
    got, want = drive_uniaxial(mt), drive_uniaxial(mj)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            close(a, b, 1e-10)
    assert want[-1][2].max() > 1e-4  # plastic


@pytest.mark.parametrize("mode", ["analytic", "jvp"])
def test_batched_update_matches_jax(mode):
    n = 48
    rng = np.random.default_rng(0)
    bt, bj = fefp(tmodels, tangent_mode=mode), fefp(jmodels, tangent_mode=mode)
    st, sj = init_states(n)
    Fv = rand_Fv(rng, n, 0.02)
    for _ in range(2):
        pt, Ct, st = bt.batched_update(torch.tensor(Fv), st, 0.0)
        pj, Cj, sj = bj.batched_update(jnp.asarray(Fv), sj, 0.0)
        close(pt, pj, 1e-12)
        close(Ct, Cj, 1e-12)
        for k in ("be", "p", "F_prev"):
            close(st[k], sj[k], 1e-12)
        Fv = compose(Fv, rng, 0.015)
    assert float(st["p"].max()) > 0  # the plastic branch ran


def test_fast_path_matches_own_per_point_path():
    """The port's fast path against its own generic path over 3 committed
    steps (tests/test_fefp_batched.py's bar: 1e-8 of scale)."""
    n = 16
    rng = np.random.default_rng(0)
    mat = tdm.Material(fefp(tmodels), device="cpu")
    mat.set_data_manager(n)
    fast = mat._fast_update
    mat._fast_update = None
    Fv = rand_Fv(rng, n, 0.02)
    for step in range(3):
        flux_g, _, Ct_g = mat.integrate(Fv)
        pk1_f, Ct_f, st_f = fast(torch.tensor(Fv), mat.data_manager.s0.internal, 0.0)
        close(pk1_f, flux_g, 1e-8)
        close(Ct_f, Ct_g, 1e-8)
        s1 = mat.data_manager.s1.internal
        np.testing.assert_allclose(st_f["be"], s1["be"], atol=1e-10)
        np.testing.assert_allclose(st_f["p"], s1["p"], atol=1e-10)
        mat.data_manager.update()
        Fv = compose(Fv, rng, 0.01)
    assert float(mat.data_manager.s0["p"].max()) > 0


def test_batched_flux_and_guard():
    n = 16
    rng = np.random.default_rng(1)
    mat = tdm.Material(fefp(tmodels), device="cpu")
    mat.set_data_manager(n)
    assert mat._fast_flux is not None
    Fv = rand_Fv(rng, n, 0.02)
    flux_full, _, _ = mat.integrate(Fv)
    flux_only, _ = mat.integrate_flux_only(Fv)
    np.testing.assert_allclose(flux_only, flux_full, rtol=1e-12, atol=1e-12)
    pj, _ = fefp(jmodels).batched_flux(jnp.asarray(Fv), init_states(n)[1], 0.0)
    close(flux_only, pj, 1e-12)

    # tests/test_fefp_batched.py: a 3x stretch leaves the series envelope
    mat = tdm.Material(fefp(tmodels), device="cpu")
    mat.set_data_manager(4)
    pk1, _, _ = mat._fast_update(torch.tensor(np.tile(3.0 * I9, (4, 1))), mat.data_manager.s0.internal, 0.0)
    assert bool(torch.isnan(pk1).all())
    pk1, _, _ = mat._fast_update(torch.tensor(np.tile(1.1 * I9, (4, 1))), mat.data_manager.s0.internal, 0.0)
    assert bool(torch.isfinite(pk1).all())


def test_guard_poison_reaches_residual():
    """The guard's NaN is not swallowed on the way to the line search: the
    bar's flux-only residual at a displacement that doubles its length is
    NaN (the line search rejects a non-finite trial), and finite at 1 %."""
    from dolfinx_materials_tpu_torch.demos import finite_strain_elastoplasticity as demo

    proto = demo.build(1, "tetrahedron", device="cpu")
    problem, V = proto["problem"], proto["V"]
    x = V.node_coords[:, 0]
    for stretch, finite in ((1.0, False), (0.01, True)):
        u = np.zeros((V.num_dofs // 3, 3))
        u[:, 0] = stretch * x
        u = torch.tensor(u.reshape(-1))
        problem._constitutive_update_flux_only(u)
        R = problem._residual(u)
        assert bool(torch.isfinite(R).all()) is finite


def test_opt_out():
    mat = tdm.Material(fefp(tmodels, use_batched_fast=False), device="cpu")
    assert mat._fast_update is None and mat._fast_flux is None
    mat.set_data_manager(2)
    flux, _, Ct = mat.integrate(rand_Fv(np.random.default_rng(2), 2, 0.01))
    assert tuple(flux.shape) == (2, 9) and tuple(Ct.shape) == (2, 81)


def test_hencky_elastic():
    e = 1e-7
    F = I9.copy()
    F[0] += e
    mt = tdm.Material(tmodels.HenckyFiniteStrain(tmodels.LinearElasticIsotropic(E, NU)), device="cpu")
    P, _, Ct = mt.integrate(F[None])
    C = tmodels.LinearElasticIsotropic(E, NU).C
    np.testing.assert_allclose(np.asarray(P)[0, :3], (C[:, 0] * e)[:3], rtol=1e-5)
    mj = jdm.Material(jmodels.HenckyFiniteStrain(jmodels.LinearElasticIsotropic(E, NU)))
    Pj, _, Cj = mj.integrate(jnp.asarray(F[None]))
    # at a strain of 1e-7 the log's rounding (~1e-15 absolute, different in
    # the two packages) is ~1e-8 of the strain itself: PK1 to 1e-7 of its
    # largest entry, the tangent (O(1) quantities) to 1e-10
    np.testing.assert_allclose(P, Pj, rtol=0, atol=1e-7 * np.abs(np.asarray(Pj)).max())
    close(Ct, Cj, 1e-10)


def test_hencky_j2_matches_fefp_small_strain():
    ys = lambda p: 50.0 + 100.0 * p  # noqa: E731
    el = tmodels.LinearElasticIsotropic(E, NU)
    m1 = tdm.Material(tmodels.HenckyFiniteStrain(tmodels.vonMisesIsotropicHardening(el, ys)), device="cpu")
    m2 = tdm.Material(tmodels.FeFpJ2Plasticity(el, ys), device="cpu")
    h1 = drive_uniaxial(m1, eps=5e-3, nsteps=10, nbatch=2)
    h2 = drive_uniaxial(m2, eps=5e-3, nsteps=10, nbatch=2)
    np.testing.assert_allclose(h1[-1][0][0], h2[-1][0][0], rtol=2e-3, atol=1e-3 * 50.0)
    np.testing.assert_allclose(h1[-1][2][0], h2[-1][2][0], rtol=2e-3)
    elj = jmodels.LinearElasticIsotropic(E, NU)
    mj = jdm.Material(jmodels.HenckyFiniteStrain(jmodels.vonMisesIsotropicHardening(elj, ys)))
    hj = drive_uniaxial(mj, eps=5e-3, nsteps=10, nbatch=2)
    for g, w in zip(h1, hj):
        close(g[0], w[0], 1e-10)
        close(g[1], w[1], 1e-10)
        close(g[2], w[2], 1e-10)


def test_p2_tet_bar_matches_jax():
    """The [fefp] bar's build (P2 tets, degree-4 quadrature, the port's
    default Krylov options) at N = 1, 2 load steps of the 5 % elongation, in
    both packages."""
    from dolfinx_materials_tpu_torch.demos import finite_strain_elastoplasticity as demo

    proto = demo.build(1, "tetrahedron", device="cpu")
    steps = demo.run(proto, nsteps0=10, n_steps=2)

    from dolfinx_materials_tpu import fem as jfem
    from dolfinx_materials_tpu.fem.forms import deformation_gradient_3d

    mat = jdm.Material(jmodels.FeFpJ2Plasticity(
        jmodels.LinearElasticIsotropic(demo.E, demo.NU), jmodels.VoceHardening(demo.SIG0, demo.SIGU, demo.B)))
    mesh = jfem.create_box((0, 0, 0), (demo.L, demo.W, demo.W), (3, 1, 1), "tetrahedron")
    V = jfem.FunctionSpace(mesh, degree=2, shape=(3,))
    qmap = jdm.QuadratureMap(V, 4, mat)
    qmap.register_gradient("F", deformation_gradient_3d())
    left = jfem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
    right_x = jfem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], demo.L), 0)
    bc_right = jfem.DirichletBC(right_x, 0.0)
    u = jfem.Function(V)
    problem = jdm.NonlinearMaterialProblem(qmap, u, bcs=[jfem.DirichletBC(left, 0.0), bc_right],
                                           options=dict(demo.OPTIONS))
    want, solve = [], problem.solve

    def recording():
        out = solve()
        if out[0]:
            want.append((float(bc_right.value), u.x.copy()))
        return out

    problem.solve = recording
    jdm.solve_adaptive(problem, bc_right.set, 2 * demo.STRETCH * demo.L / 10, nsteps0=2)
    assert [s["load"] for s in steps] == [w[0] for w in want]
    assert len(steps) == 2
    want = [w[1] for w in want]
    for s, w in zip(steps, want):
        close(s["u"], w, 1e-8)
    assert qmap.num_points == proto["qmap"].num_points
