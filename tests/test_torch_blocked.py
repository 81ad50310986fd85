"""Multi-field problems of the port (``solvers.solve_coupled``,
``solvers.BlockedNonlinearProblem``, ``parallel.make_sharded_blocked_step``)
against the JAX package's, in float64 on the CPU.

Each case builds the same problem in both packages (its builder is the
twin of tests/test_blocked.py, tests/test_coupled.py, tests/test_interface.py
and the blocked-step cases of tests/test_sharding_general.py) and compares
the solutions to 1e-8 of their scale with equal Newton and outer counts. The
two packages run the same iterations; their sums differ only in order, so
they agree far inside 1e-8 wherever the counts do.
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu import parallel as jpar  # noqa: E402
from dolfinx_materials_tpu import solvers as jsolvers  # noqa: E402
from dolfinx_materials_tpu.fem import facets as jfacets  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402
from dolfinx_materials_tpu.models import thermal as jthermal  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch import parallel as tpar  # noqa: E402
from dolfinx_materials_tpu_torch import solvers as tsolvers  # noqa: E402
from dolfinx_materials_tpu_torch.fem import facets as tfacets  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402
from dolfinx_materials_tpu_torch.models import thermal as tthermal  # noqa: E402

torch.set_num_threads(1)

TOL = 1e-8
E, NU, T0 = 70e3, 0.3, 293.15
PKGS = {
    "torch": dict(pkg=tdm, fem=tfem, models=tmodels, thermal=tthermal, forms=tforms, facets=tfacets,
                  solvers=tsolvers, par=tpar, kw=dict(device="cpu"), mesh_kw=dict(devices=["cpu"]), xp=torch),
    "jax": dict(pkg=jdm, fem=jfem, models=jmodels, thermal=jthermal, forms=jforms, facets=jfacets,
                solvers=jsolvers, par=jpar, kw={}, mesh_kw={}, xp=jnp),
}


def close(got, want, tol=TOL):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30))


def host(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


# --------------------------------------------------- thermo-mechanics twins
def vol_strain(P):
    xp = P["xp"]

    def expr(ctx):
        g = ctx.grad
        return xp.stack([g[0, 0] + g[1, 1]])

    return expr


def thermo(P, N=6, alpha_th=1e-3, chi=6e3, kappa=1.0, k_cond=1.0, mesh=None):
    """tests/test_blocked.py ``build``: a stiffly two-way-coupled plate
    (thermal expansion drives the mechanics, dilatation heats), on an N x N
    quad mesh or ``mesh``."""
    fem, pkg, forms, th = P["fem"], P["pkg"], P["forms"], P["thermal"]
    if mesh is None:
        mesh = fem.create_rectangle((0, 0), (1.0, 1.0), (N, N), "quad")
    VT = fem.FunctionSpace(mesh, 1, ())
    mat_T = pkg.Material(th.ThermoMechanicalHeat(k=k_cond, kappa=kappa, chi=chi, T0=T0), **P["kw"])
    qT = pkg.QuadratureMap(VT, 2, mat_T)
    qT.register_gradient("TemperatureGradient", forms.scalar_gradient())
    qT.register_external_state_variable("Temperature", forms.scalar_value())
    leftT = fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 0.0))
    rightT = fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 1.0))
    T = fem.Function(VT)
    T.x[:] = T0
    heat = pkg.NonlinearMaterialProblem(
        qT, T, bcs=[fem.DirichletBC(leftT, T0 + 50.0), fem.DirichletBC(rightT, T0)],
        residual_terms=[[("HeatFlux", forms.scalar_gradient(), -1.0), ("Source", forms.scalar_value(), 1.0)]],
        options={"ksp_type": "lu"},
    )
    Vu = fem.FunctionSpace(mesh, 1, (2,))
    mat_u = pkg.Material(th.ThermoElasticIsotropic(E, NU, alpha_th, T0), **P["kw"])
    qu = pkg.QuadratureMap(Vu, 2, mat_u)
    qu.register_gradient("Strain", forms.mandel_strain_2d())
    qu.register_external_state_variable("Temperature", T0)
    clamped = fem.locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 0], 1.0))
    u = fem.Function(Vu)
    mech = pkg.NonlinearMaterialProblem(qu, u, bcs=[fem.DirichletBC(clamped, 0.0)], options={"ksp_type": "lu"})
    return heat, mech, qT, qu


def couplings(P, qT, qu):
    return [(1, 0, qu, "Stress", "Temperature", P["forms"].scalar_value()),
            (0, 1, qT, "Source", "VolStrain", vol_strain(P))]


def solve_thermo(which, N=6):
    P = PKGS[which]
    heat, mech, qT, qu = thermo(P, N)
    blocked = P["solvers"].BlockedNonlinearProblem([heat, mech], couplings(P, qT, qu), options={"ksp_type": "lu"})
    ok, its = blocked.solve()
    assert ok
    return np.concatenate([heat.u.x, mech.u.x]), its, host(qu.material.data_manager.s0["Stress"])


def test_blocked_stiff_coupling_matches_jax():
    """The monolithic Newton with cross-field blocks both ways (the stiff
    case of tests/test_blocked.py): z and the stress to 1e-8, equal Newton
    counts, and full Newton rate (at most 5 iterations)."""
    zt, it_t, sig_t = solve_thermo("torch")
    zj, it_j, sig_j = solve_thermo("jax")
    assert it_t == it_j <= 5
    close(zt, zj)
    close(sig_t, sig_j)
    assert np.abs(zt[: len(zt) // 3] - T0).max() > 1.0


def test_blocked_thermomechanics_builder_matches_jax():
    """The port's shared builder of the stiff coupling
    (``demos.blocked_thermomechanics.build``, which the card's checks use)
    against the JAX test's problem: its LU solve, z to 1e-8 and equal Newton
    counts."""
    from dolfinx_materials_tpu_torch.demos import blocked_thermomechanics

    heat, mech, qT, qu, coups = blocked_thermomechanics.build(6, "cpu")
    ok, its = tsolvers.BlockedNonlinearProblem([heat, mech], coups, options={"ksp_type": "lu"}).solve()
    assert ok
    zj, it_j, _ = solve_thermo("jax")
    assert its == it_j
    close(np.concatenate([heat.u.x, mech.u.x]), zj)


def uncoupled(P):
    """tests/test_blocked.py:152: chi = 0, alpha = 0, one declared coupling."""
    fem, pkg, forms, th = P["fem"], P["pkg"], P["forms"], P["thermal"]
    mesh = fem.create_rectangle((0, 0), (1.0, 1.0), (5, 5), "quad")
    VT = fem.FunctionSpace(mesh, 1, ())
    mat_T = pkg.Material(th.ThermoMechanicalHeat(k=2.0, kappa=0.5, chi=0.0, T0=T0), **P["kw"])
    qT = pkg.QuadratureMap(VT, 2, mat_T)
    qT.register_gradient("TemperatureGradient", forms.scalar_gradient())
    qT.register_external_state_variable("Temperature", forms.scalar_value())
    leftT = fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 0.0))
    rightT = fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 1.0))
    T = fem.Function(VT)
    T.x[:] = T0
    terms = [[("HeatFlux", forms.scalar_gradient(), -1.0), ("Source", forms.scalar_value(), 1.0)]]
    heat = pkg.NonlinearMaterialProblem(
        qT, T, bcs=[fem.DirichletBC(leftT, T0 + 50.0), fem.DirichletBC(rightT, T0)], residual_terms=terms,
        options={"ksp_type": "lu"})
    Vu = fem.FunctionSpace(mesh, 1, (2,))
    mat_u = pkg.Material(th.ThermoElasticIsotropic(E, NU, 0.0, T0), **P["kw"])
    qu = pkg.QuadratureMap(Vu, 2, mat_u)
    qu.register_gradient("Strain", forms.mandel_strain_2d())
    qu.register_external_state_variable("Temperature", T0)
    left = fem.locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 0], 0), 0)
    bot = fem.locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 1], 0), 1)
    right = fem.locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 0], 1), 0)
    bcsu = [fem.DirichletBC(left, 0.0), fem.DirichletBC(bot, 0.0), fem.DirichletBC(right, 1e-3)]
    mech = pkg.NonlinearMaterialProblem(qu, fem.Function(Vu), bcs=bcsu, options={"ksp_type": "lu"})
    blocked = P["solvers"].BlockedNonlinearProblem(
        [heat, mech], [(1, 0, qu, "Stress", "Temperature", forms.scalar_value())], options={"ksp_type": "lu"})
    ok, its = blocked.solve()
    assert ok
    return np.concatenate([heat.u.x, mech.u.x]), its


def test_blocked_uncoupled_matches_jax():
    """tests/test_blocked.py:152's blocked solve: z to 1e-8, equal counts."""
    zt, it_t = uncoupled(PKGS["torch"])
    zj, it_j = uncoupled(PKGS["jax"])
    assert it_t == it_j
    close(zt, zj)


def test_coupling_without_tangent_block_raises():
    P = PKGS["torch"]
    heat, mech, qT, qu = thermo(P, 2)
    with pytest.raises(KeyError, match="declares no tangent block"):
        tsolvers.BlockedNonlinearProblem([heat, mech], [(1, 0, qu, "Stress", "Pressure", P["forms"].scalar_value())])


# ------------------------------------------------------------ solve_coupled
def staggered(P, N=8):
    """tests/test_coupled.py ``build``: nonlinear conduction, then thermal
    expansion fed with the Gauss-point temperature (one-way)."""
    fem, pkg, forms, th = P["fem"], P["pkg"], P["forms"], P["thermal"]
    mesh = fem.create_rectangle((0, 0), (1.0, 1.0), (N, N), "quad")
    VT = fem.FunctionSpace(mesh, 1, ())
    mat_T = pkg.Material(th.NonlinearHeatTransfer(A=0.0375, B=2.165e-4, dim=2), **P["kw"])
    qT = pkg.QuadratureMap(VT, 2, mat_T)
    qT.register_gradient("TemperatureGradient", forms.scalar_gradient())
    qT.register_external_state_variable("Temperature", forms.scalar_value())
    left = fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 0.0))
    right = fem.locate_dofs_geometrical(VT, lambda x: np.isclose(x[:, 0], 1.0))
    T = fem.Function(VT)
    T.x[:] = T0
    heat = pkg.NonlinearMaterialProblem(
        qT, T, bcs=[fem.DirichletBC(left, T0 + 300.0), fem.DirichletBC(right, T0)],
        residual_terms=[[("HeatFlux", forms.scalar_gradient())]], options={"ksp_type": "lu", "atol": 1e-8})
    Vu = fem.FunctionSpace(mesh, 1, (2,))
    mat_u = pkg.Material(th.ThermoElasticIsotropic(E, NU, 1e-5, T0), **P["kw"])
    qu = pkg.QuadratureMap(Vu, 2, mat_u)
    qu.register_gradient("Strain", forms.mandel_strain_2d())
    qu.register_external_state_variable("Temperature", T0)
    clamped = fem.locate_dofs_geometrical(Vu, lambda x: np.isclose(x[:, 0], 0.0) | np.isclose(x[:, 0], 1.0))
    u = fem.Function(Vu)
    mech = pkg.NonlinearMaterialProblem(qu, u, bcs=[fem.DirichletBC(clamped, 0.0)], options={"ksp_type": "lu"})

    def push():
        qu.register_external_state_variable("Temperature", host(qT._eval_fns["Temperature"](P["xp"].asarray(T.x))))

    return heat, mech, mat_u, push


def test_solve_coupled_matches_jax():
    """tests/test_coupled.py:74: the outer Gauss-Seidel loop converges in
    the same outer count, u and the stress to 1e-8 (after the JAX
    reference's own check against manual staggering)."""
    out = {}
    for which, P in PKGS.items():
        heat, mech, mat_u, push = staggered(P)
        ok, n_outer = P["solvers"].solve_coupled([heat, mech], [None, push], max_outer=10)
        assert ok and n_outer <= 3
        out[which] = (n_outer, mech.u.x.copy(), heat.u.x.copy(), host(mat_u.data_manager.s0["Stress"]))
    (nt, ut, Tt, st), (nj, uj, Tj, sj) = out["torch"], out["jax"]
    assert nt == nj
    close(ut, uj)
    close(Tt, Tj)
    close(st, sj)
    assert np.abs(st[:, 0]).max() > 1.0


def test_solve_coupled_stiff_outer_count_matches_jax():
    """The stiff coupling through block Gauss-Seidel with explicit transfers
    (tests/test_blocked.py's slow comparison, cut to 6 outers): the same
    outer count and verdict, both fields to 1e-8 after the last outer."""
    out = {}
    for which, P in PKGS.items():
        heat, mech, qT, qu = thermo(P, 4)
        xp = P["xp"]

        def push_T(qT=qT, qu=qu, heat=heat, xp=xp):
            qu.material.update_external_state_variable("Temperature", qT._eval_fns["Temperature"](xp.asarray(heat.u.x)))

        def push_ev(qT=qT, qu=qu, mech=mech, xp=xp, P=P):
            qT.material.update_external_state_variable(
                "VolStrain", qu.domain.make_eval(vol_strain(P))(xp.asarray(mech.u.x)))

        ok, n = P["solvers"].solve_coupled([heat, mech], [push_ev, push_T], max_outer=6, rtol=1e-10)
        out[which] = (ok, n, np.concatenate([heat.u.x, mech.u.x]))
    assert out["torch"][:2] == out["jax"][:2]
    close(out["torch"][2], out["jax"][2])


def commit_deferred(P):
    """tests/test_coupled.py:96: ``solve(commit=False)`` leaves s0 alone."""
    fem, pkg, m = P["fem"], P["pkg"], P["models"]
    mat = pkg.Material(m.vonMisesIsotropicHardening(m.LinearElasticIsotropic(E, NU), m.LinearHardening(100.0, 1000.0)),
                       **P["kw"])
    V = fem.FunctionSpace(fem.create_rectangle((0, 0), (1, 1), (2, 2), "quad"), 1, (2,))
    q = pkg.QuadratureMap(V, 2, mat)
    q.register_gradient("Strain", P["forms"].mandel_strain_2d())
    left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0)
    bot = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1)
    right = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0)
    prob = pkg.NonlinearMaterialProblem(
        q, fem.Function(V), bcs=[fem.DirichletBC(left, 0.0), fem.DirichletBC(bot, 0.0),
                                 fem.DirichletBC(right, 5 * 100.0 / E)], options={"ksp_type": "lu"})
    ok, its = prob.solve(commit=False)
    assert ok
    p1, p0 = host(mat.data_manager.s1["p"]), host(mat.data_manager.s0["p"])
    assert p1.max() > 1e-4 and p0.max() == 0.0
    ok, its2 = prob.solve(commit=True)
    assert ok
    return its, its2, host(mat.data_manager.s0["p"]), prob.u.x.copy()


def test_commit_deferred_matches_jax():
    t, j = commit_deferred(PKGS["torch"]), commit_deferred(PKGS["jax"])
    assert t[:2] == j[:2]
    close(t[2], j[2])
    close(t[3], j[3])


# ---------------------------------------------------------------- interfaces
E1, E2, S_LOAD = 50e3, 200e3, 10.0


def two_field(P, K, N=(10, 2), plastic=False, ksp="lu"):
    """tests/test_interface.py: a two-layer strip on facing submeshes joined
    by t = K [[u]], pulled by a traction on the right; ``plastic``: the
    J2 materials of its plastic case."""
    fem, pkg, m = P["fem"], P["pkg"], P["models"]
    parent = fem.create_rectangle((0, 0), (1.0, 0.2), N, "quad")
    centers = parent.cell_centers()
    cells1 = np.nonzero(centers[:, 0] < 0.5)[0].astype(np.int32)
    cells2 = np.nonzero(centers[:, 0] > 0.5)[0].astype(np.int32)
    m1, vmap1 = fem.extract_submesh(parent, cells1)
    m2, vmap2 = fem.extract_submesh(parent, cells2)
    V1, V2 = fem.FunctionSpace(m1, 1, (2,)), fem.FunctionSpace(m2, 1, (2,))

    def material(Ey, sig0):
        el = m.LinearElasticIsotropic(Ey, 0.0)
        beh = m.vonMisesIsotropicHardening(el, m.LinearHardening(sig0, Ey / 10)) if plastic else el
        return pkg.Material(beh, **P["kw"])

    mats, qmaps = [material(E1, 8.0), material(E2, 100.0)], []
    for V, mat in zip((V1, V2), mats):
        q = pkg.QuadratureMap(V, 2, mat)
        q.register_gradient("Strain", P["forms"].mandel_strain_2d())
        qmaps.append(q)
    left = fem.locate_dofs_geometrical(V1, lambda x: np.isclose(x[:, 0], 0.0), 0)
    bot1 = fem.locate_dofs_geometrical(V1, lambda x: np.isclose(x[:, 1], 0.0), 1)
    bot2 = fem.locate_dofs_geometrical(V2, lambda x: np.isclose(x[:, 1], 0.0), 1)
    F2 = P["facets"].assemble_traction(V2, lambda x: np.isclose(x[:, 0], 1.0), np.array([S_LOAD, 0.0]))
    p1 = pkg.NonlinearMaterialProblem(qmaps[0], fem.Function(V1),
                                      bcs=[fem.DirichletBC(left, 0.0), fem.DirichletBC(bot1, 0.0)],
                                      options={"ksp_type": "lu"})
    p2 = pkg.NonlinearMaterialProblem(qmaps[1], fem.Function(V2), bcs=[fem.DirichletBC(bot2, 0.0)],
                                      external_force=F2, options={"ksp_type": "lu"})
    dom = fem.InterfaceDomain(V1, V2, fem.interface_facets(parent, cells1, cells2), vmap1, vmap2)
    blocked = P["solvers"].BlockedNonlinearProblem(
        [p1, p2], interfaces=[fem.InterfaceTerm(0, 1, dom, fem.elastic_interface(K))], options={"ksp_type": ksp})
    ok, its = blocked.solve()
    assert ok
    jump = host(dom.jump(P["xp"].asarray(p1.u.x), P["xp"].asarray(p2.u.x)))
    return dict(z=np.concatenate([p1.u.x, p2.u.x]), its=its, jump=jump,
                sig=[host(mt.data_manager.s0["Stress"]) for mt in mats],
                p=[host(mt.data_manager.s0["p"]) for mt in mats] if plastic else None)


INTERFACE_CASES = {
    "sandwich": dict(K=2e4),  # tests/test_interface.py:88
    "stiff_limit": dict(K=1e9),  # :113
    "plastic": dict(K=5e4, plastic=True),  # :151
    "sandwich_bicgstab": dict(K=2e4, ksp="bicgstab"),
    "sandwich_gmres": dict(K=2e4, ksp="gmres"),
}


@pytest.mark.parametrize("case", list(INTERFACE_CASES))
def test_interface_solve_matches_jax(case):
    """The host blocked solve with an interface law: z, the interface jump
    and the stresses to 1e-8, equal Newton counts; the closed forms of
    tests/test_interface.py where they hold (series compliance and a
    jump of s/K)."""
    t = two_field(PKGS["torch"], **INTERFACE_CASES[case])
    j = two_field(PKGS["jax"], **INTERFACE_CASES[case])
    assert t["its"] == j["its"]
    close(t["z"], j["z"])
    close(t["jump"], j["jump"])
    for a, b in zip(t["sig"], j["sig"]):
        close(a, b)
    K = INTERFACE_CASES[case]["K"]
    if case == "plastic":
        assert t["p"][0].min() > 1e-4 and t["p"][1].max() < 1e-12
        np.testing.assert_allclose(t["jump"][..., 0].mean(), S_LOAD / K, rtol=2e-3)
    elif case != "stiff_limit":
        np.testing.assert_allclose(t["jump"][..., 0], S_LOAD / K, rtol=1e-6)


# --------------------------------------------------------- the fused step
def sandwich_step_problem(P):
    """tests/test_sharding_general.py:726: an 8x4 two-submesh sandwich of J2
    plates joined by t = 5e4 [[u]], the right face pulled to u_x = 2e-3."""
    fem, pkg, m = P["fem"], P["pkg"], P["models"]
    parent = fem.create_rectangle((0, 0), (1.0, 0.5), (8, 4), "quad")
    centers = parent.cell_centers()
    cells_a = np.nonzero(centers[:, 0] < 0.5)[0].astype(np.int32)
    cells_b = np.nonzero(centers[:, 0] > 0.5)[0].astype(np.int32)
    mesh_a, vmap_a = fem.extract_submesh(parent, cells_a)
    mesh_b, vmap_b = fem.extract_submesh(parent, cells_b)
    Va, Vb = fem.FunctionSpace(mesh_a, 1, (2,)), fem.FunctionSpace(mesh_b, 1, (2,))
    idom = fem.InterfaceDomain(Va, Vb, fem.interface_facets(parent, cells_a, cells_b), vmap_a, vmap_b)

    def pair(options):
        probs = []
        for V in (Va, Vb):
            mat = pkg.Material(m.vonMisesIsotropicHardening(m.LinearElasticIsotropic(E, NU),
                                                            m.LinearHardening(350.0, 1e3)), **P["kw"])
            q = pkg.QuadratureMap(V, 2, mat)
            q.register_gradient("Strain", P["forms"].mandel_strain_2d())
            if V is Va:
                bcs = [fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0)), 0.0)]
            else:
                rx = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0), 0)
                ry = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0), 1)
                bcs = [fem.DirichletBC(rx, 2e-3), fem.DirichletBC(ry, 0.0)]
            probs.append(pkg.NonlinearMaterialProblem(q, fem.Function(V), bcs=bcs))
        itf = fem.InterfaceTerm(0, 1, idom, fem.elastic_interface(5e4))
        return P["solvers"].BlockedNonlinearProblem(probs, interfaces=[itf], options=options)

    return pair


def run_step(which, case, n_newton=16):
    """The fused blocked step from the JAX tests' start (z0 = BC values on
    the masked dofs, the rest as built): ``(z, |R|, states, step)``."""
    P = PKGS[which]
    if case == "thermo":
        heat, mech, qT, qu = thermo(P, 6)
        blocked = P["solvers"].BlockedNonlinearProblem([heat, mech], couplings(P, qT, qu))
        z0 = np.concatenate([heat.u.x, mech.u.x])
        opts = dict(n_newton=n_newton, n_cg=400)
    else:
        pair = sandwich_step_problem(P)
        blocked = pair({})
        z0 = np.zeros(blocked.ndofs)
        opts = dict(n_newton=n_newton, n_cg=500)
    mesh = P["par"].device_mesh(1, **P["mesh_kw"])
    step, pad = P["par"].make_sharded_blocked_step(blocked, mesh, **opts)
    mask, vals = blocked._masks()
    mask_np, vals_np = host(mask), host(vals)
    z0[mask_np] = vals_np[mask_np]
    states0 = [q.material.data_manager.s0.internal for p in blocked.problems for q in p.qmaps]
    z, states, rn = step(P["xp"].asarray(z0), pad(states0), mask, vals, 0.0)
    return host(z), float(rn), [{k: host(v) for k, v in st.items()} for st in states], step


@pytest.mark.parametrize("case", ["thermo", "sandwich"])
def test_blocked_step_matches_jax(case):
    """The port's fused blocked step against the JAX step, both on a
    one-device mesh: z and every state leaf to 1e-8, |R| below the JAX
    tests' bar (1e-7 E), and the step's answer against the host LU solve
    to the JAX tests' tolerances (1e-6 thermo, 1e-5 sandwich).

    Equal Newton counts: the JAX step returns no count, so it runs with the
    port's count n as its budget and must reach the tolerance within it,
    while the port's residual after n - 1 iterations sits at least 2x
    above that tolerance (the JAX iterates equal the port's to 1e-8)."""
    zt, rt, st_t, step = run_step("torch", case)
    info = step.info
    n = info["newton"]
    assert n >= 1 and info["bicgstab"] >= n
    assert info["residuals"][n - 1] > 2 * info["tolerance"] >= info["residuals"][n]
    zj, rj, st_j, _ = run_step("jax", case, n_newton=n)
    assert rj <= info["tolerance"] * (1 + 1e-6)
    assert rt < 1e-7 * E and rj < 1e-7 * E
    close(zt, zj)
    for a, b in zip(st_t, st_j):
        assert sorted(a) == sorted(b)
        for k in b:
            close(a[k], b[k])
    if case == "thermo":
        z_ref = solve_thermo("torch")[0]
        np.testing.assert_allclose(zt, z_ref, rtol=1e-6, atol=1e-8 * max(1.0, np.abs(z_ref).max()))
    else:
        blocked = sandwich_step_problem(PKGS["torch"])({"ksp_type": "lu"})
        assert blocked.solve()[0]
        z_ref = np.concatenate([p.u.x for p in blocked.problems])
        np.testing.assert_allclose(zt, z_ref, rtol=1e-5, atol=1e-9)


def test_blocked_step_smoother_and_jacobi_match_jax():
    """The node-block smoother without a coarse level (``pc="jacobi"``,
    ``smoother="block"``) on the thermo-mechanical coupling at N = 4: z to
    1e-8 against the JAX step with the same options."""
    out = {}
    for which, P in PKGS.items():
        heat, mech, qT, qu = thermo(P, 4)
        blocked = P["solvers"].BlockedNonlinearProblem([heat, mech], couplings(P, qT, qu))
        step, pad = P["par"].make_sharded_blocked_step(blocked, P["par"].device_mesh(1, **P["mesh_kw"]),
                                                       n_newton=16, n_cg=400, pc="jacobi", smoother="block")
        mask, vals = blocked._masks()
        z0 = np.concatenate([heat.u.x, mech.u.x])
        z0[host(mask)] = host(vals)[host(mask)]
        z, _, rn = step(P["xp"].asarray(z0), pad([qT.material.data_manager.s0.internal,
                                                  qu.material.data_manager.s0.internal]), mask, vals, 0.0)
        out[which] = (host(z), float(rn))
    assert out["torch"][1] < 1e-7 * E
    close(out["torch"][0], out["jax"][0])


def test_blocked_step_options_are_checked():
    P = PKGS["torch"]
    heat, mech, qT, qu = thermo(P, 2)
    blocked = tsolvers.BlockedNonlinearProblem([heat, mech], couplings(P, qT, qu))
    mesh = tpar.device_mesh(1, devices=["cpu"])
    with pytest.raises(ValueError, match="smoother"):
        tpar.make_sharded_blocked_step(blocked, mesh, smoother="ilu")
    with pytest.raises(ValueError, match="pc must be"):
        tpar.make_sharded_blocked_step(blocked, mesh, pc="amg")


def thermo_step(P, N=6, mesh=None, dtype=None, **opts):
    """One fused blocked step of the thermo-mechanical coupling from its
    built state (BC values put in), its inputs cast to ``dtype``:
    ``(z, |R|, problem)``."""
    heat, mech, qT, qu = thermo(P, N, mesh=mesh)
    blocked = P["solvers"].BlockedNonlinearProblem([heat, mech], couplings(P, qT, qu))
    step, _ = P["par"].make_sharded_blocked_step(blocked, P["par"].device_mesh(1, **P["mesh_kw"]), **opts)
    mask, vals = blocked._masks()
    z0 = np.concatenate([heat.u.x, mech.u.x])
    z0[host(mask)] = host(vals)[host(mask)]
    states = [q.material.data_manager.s0.internal for q in (qT, qu)]
    if dtype is not None:
        z0, vals = z0.astype(dtype), host(vals).astype(dtype)
        states = [{k: host(v).astype(dtype) for k, v in st.items()} for st in states]
    z, _, rn = step(P["xp"].asarray(z0), states, mask, vals, 0.0)
    return host(z), float(rn), blocked


def test_blocked_step_two_level_beats_jacobi():
    """tests/test_sharding_general.py's two-level case: on the 24 x 24
    coupling at a budget of 20 BiCGStab iterations a Newton step, the
    two-level preconditioner reaches the f64 floor where the scalar Jacobi
    stalls, and its answer meets the host LU solve."""
    P = PKGS["torch"]
    z_tl, rn_tl, _ = thermo_step(P, 24, n_newton=8, n_cg=20, pc="two_level")
    _, rn_jac, _ = thermo_step(P, 24, n_newton=8, n_cg=20, pc="jacobi", smoother="jacobi")
    assert rn_tl < 1e-10, rn_tl
    assert rn_jac > 1e-7, rn_jac
    z_ref = solve_thermo("torch", 24)[0]
    np.testing.assert_allclose(z_tl, z_ref, rtol=1e-6, atol=1e-8 * max(1.0, np.abs(z_ref).max()))


def test_blocked_step_float32_banded_and_scalar_routes():
    """tests/test_sharding_general.py's unstructured case: float32 inputs to
    the float64 problem run the step in float32, on a reordered Delaunay
    mesh big enough for the vector field's banded plans. The banded and
    the gather-map routes agree to 2e-4, and both meet the float64 host LU
    solve at float32 accuracy (the JAX test's 5e-3 relative, 5e-4 of the
    scale)."""
    from scipy.spatial import Delaunay

    P = PKGS["torch"]
    rng = np.random.default_rng(3)
    g = 38  # 2888 triangles: the vector field has ne * ndof_el = 17328 >= 8192
    xx, yy = np.meshgrid(np.arange(g + 1), np.arange(g + 1))
    pts = np.stack([xx, yy], -1).reshape(-1, 2) / g
    pts += np.where((pts > 0) & (pts < 1), rng.uniform(-0.2 / g, 0.2 / g, pts.shape), 0.0)
    tri = tfem.reorder_mesh(tfem.mesh.Mesh(pts, Delaunay(pts).simplices.astype(np.int32), "triangle"))
    heat, mech, qT, qu = thermo(P, mesh=tri)
    assert qu.domain.banded_active
    blocked = tsolvers.BlockedNonlinearProblem([heat, mech], couplings(P, qT, qu), options={"ksp_type": "lu"})
    assert blocked.solve()[0]
    z_ref = np.concatenate([heat.u.x, mech.u.x])
    scale = max(1.0, np.abs(z_ref).max())
    z_b, rn_b, _ = thermo_step(P, mesh=tri, dtype=np.float32, n_newton=16, n_cg=600, use_banded=True)
    z_s, rn_s, _ = thermo_step(P, mesh=tri, dtype=np.float32, n_newton=16, n_cg=600, use_banded=False)
    assert z_b.dtype == z_s.dtype == np.float32
    assert rn_b < 1e-3 * E and rn_s < 1e-3 * E
    np.testing.assert_allclose(z_b, z_s, rtol=2e-4, atol=2e-4 * scale)
    for z in (z_b, z_s):
        np.testing.assert_allclose(z, z_ref, rtol=5e-3, atol=5e-4 * scale)
