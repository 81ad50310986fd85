"""The port's fused Newton load step (``dolfinx_materials_tpu_torch.parallel``)
against the JAX package's, both on a one-device mesh, in float64 on the CPU.

Each case builds the same problem in both packages, runs one load step of
``make_sharded_newton_step_general`` (``return_info="stats"``) from the same
start, and compares u and every internal-state leaf to 1e-8 of their scale,
with equal Newton and CG counts. Both run the same Newton/CG/line-search
loops; their sums differ only in order (the JAX package takes the dofmap
route on the CPU, the port its stencil, banded or gather-map route), so the
two agree far inside 1e-8 wherever the CG counts do. Where a case states
otherwise, it says why.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import fem as jfem  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu import parallel as jpar  # noqa: E402
from dolfinx_materials_tpu.fem import forms as jforms  # noqa: E402
from dolfinx_materials_tpu.fem.bc import combine_bcs as jcombine  # noqa: E402
from dolfinx_materials_tpu.fem.mesh import Mesh as JMesh  # noqa: E402
from dolfinx_materials_tpu.models.base import SmallStrainBehavior as JSmallStrain  # noqa: E402
from dolfinx_materials_tpu.ops import tensors as jtensors  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import fem as tfem  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch import parallel as tpar  # noqa: E402
from dolfinx_materials_tpu_torch.fem import forms as tforms  # noqa: E402
from dolfinx_materials_tpu_torch.fem.bc import combine_bcs as tcombine  # noqa: E402
from dolfinx_materials_tpu_torch.fem.mesh import Mesh as TMesh  # noqa: E402
from dolfinx_materials_tpu_torch.models.base import SmallStrainBehavior as TSmallStrain  # noqa: E402
from dolfinx_materials_tpu_torch.ops import tensors as ttensors  # noqa: E402
from dolfinx_materials_tpu_torch.parallel.sharding import MaskedCG  # noqa: E402

torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0
RTOL = 1e-8
PKGS = {
    "torch": dict(pkg=tdm, fem=tfem, models=tmodels, forms=tforms, kw=dict(device="cpu"), par=tpar,
                  mesh_kw=dict(devices=["cpu"]), combine=tcombine, Mesh=TMesh, base=TSmallStrain,
                  xp=torch, tensors=ttensors),
    "jax": dict(pkg=jdm, fem=jfem, models=jmodels, forms=jforms, kw={}, par=jpar, mesh_kw={},
                combine=jcombine, Mesh=JMesh, base=JSmallStrain, xp=jnp, tensors=jtensors),
}


def j2(P, hardening=None):
    m = P["models"]
    return P["pkg"].Material(m.vonMisesIsotropicHardening(
        m.LinearElasticIsotropic(E, NU), hardening or m.VoceHardening(SIG0, 500.0, 1e3)), **P["kw"])


def mech_bcs(P, V, exx):
    fem = P["fem"]
    left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0), 0)
    bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0), 1)
    right = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1), 0)
    return [fem.DirichletBC(left, 0.0), fem.DirichletBC(bottom, 0.0), fem.DirichletBC(right, exx)]


def problem(P, V, materials, bcs, cells=None, strain=None, esv=()):
    """A NonlinearMaterialProblem on one qmap per material (cell subsets
    ``cells``), Mandel strain gradients and ESVs ``(i, name, values or
    expr)``."""
    fem, pkg = P["fem"], P["pkg"]
    qmaps = []
    for i, m in enumerate(materials):
        q = pkg.QuadratureMap(V, 2 * V.degree, m, cells=None if cells is None else cells[i])
        q.register_gradient("Strain", (strain or P["forms"].mandel_strain_2d)())
        qmaps.append(q)
    for i, name, value in esv:
        qmaps[i].register_external_state_variable(name, value(P) if callable(value) else value)
    return pkg.NonlinearMaterialProblem(qmaps, fem.Function(V), bcs=bcs)


def run(which, build, u0=None, call=None, **opts):
    """One fused load step of the problem ``build(P) -> (materials, V,
    bcs, problem)`` in package ``which``: ``(u, states, res, res0, (newton,
    cg))`` as numpy."""
    P = PKGS[which]
    mats, V, bcs, prob = build(P)
    step, pad = P["par"].make_sharded_newton_step_general(
        prob, P["par"].device_mesh(1, **P["mesh_kw"]), return_info="stats", **opts)
    mask, vals = P["combine"](bcs, V.num_dofs)
    u0 = np.zeros(V.num_dofs) if u0 is None else u0(V)
    u, states, rn, rn0, (n_it, n_cg) = step(u0, pad([m.data_manager.s0.internal for m in mats]),
                                            mask, vals, 0.0, **(call or {}))
    states = [{k: np.asarray(v) for k, v in st.items()} for st in states]
    return np.asarray(u), states, float(rn), float(rn0), (int(n_it), int(n_cg))


def assert_same(t, j, rtol=RTOL, counts=True):
    (ut, st_t, rt, r0t, ct), (uj, st_j, rj, r0j, cj) = t, j
    if counts:
        assert ct == cj
    np.testing.assert_allclose(ut, uj, rtol=0, atol=rtol * np.abs(uj).max())
    for a, b in zip(st_t, st_j):
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_allclose(a[k].reshape(b[k].shape), b[k], rtol=0,
                                       atol=rtol * max(np.abs(b[k]).max(), 1e-30))
    np.testing.assert_allclose(r0t, r0j, rtol=1e-12)


# ------------------------------------------------------------------ cases
def plate5(P):
    """tests/test_sharding.py: 5x5 P1 quads, Voce J2 well into plasticity."""
    V = P["fem"].FunctionSpace(P["fem"].create_unit_square(5, 5, "quad"), 1, (2,))
    bcs = mech_bcs(P, V, 3 * SIG0 / E)
    m = j2(P)
    return [m], V, bcs, problem(P, V, [m], bcs)


def two_materials(P):
    """tests/test_sharding_general.py: two cell subsets, Linear and Voce."""
    mesh = P["fem"].create_unit_square(5, 5, "quad")
    V = P["fem"].FunctionSpace(mesh, 1, (2,))
    cells = np.arange(mesh.num_cells)
    m = P["models"]
    mats = [j2(P, m.LinearHardening(SIG0, 1000.0)), j2(P)]
    bcs = mech_bcs(P, V, 3 * SIG0 / E)
    return mats, V, bcs, problem(P, V, mats, bcs, cells=[cells[cells % 2 == 0], cells[cells % 2 == 1]])


def rotated(P):
    """tests/test_sharding_general.py: a constant material-frame rotation."""
    V = P["fem"].FunctionSpace(P["fem"].create_unit_square(4, 4, "quad"), 1, (2,))
    m = j2(P, P["models"].LinearHardening(SIG0, 1000.0))
    c, s = np.cos(0.3), np.sin(0.3)
    m.rotation_matrix = np.array([[c, s, 0.0], [-s, c, 0.0], [0.0, 0.0, 1.0]])
    bcs = mech_bcs(P, V, 2 * SIG0 / E)
    return [m], V, bcs, problem(P, V, [m], bcs)


def delaunay(P):
    """tests/test_sharding_general.py's two-level unstructured mesh (28x28
    jittered Delaunay triangles), numbered as Delaunay gives it: the port
    has no reorder_mesh yet."""
    rng = np.random.default_rng(1)
    g = 28
    xx, yy = np.meshgrid(np.arange(g + 1), np.arange(g + 1))
    pts = np.stack([xx, yy], -1).reshape(-1, 2) / g
    pts += np.where((pts > 0) & (pts < 1), rng.uniform(-0.2 / g, 0.2 / g, pts.shape), 0.0)
    from scipy.spatial import Delaunay

    mesh = P["Mesh"](pts, Delaunay(pts).simplices.astype(np.int32), "triangle")
    V = P["fem"].FunctionSpace(mesh, 1, (2,))
    m = j2(P)
    bcs = mech_bcs(P, V, 2 * SIG0 / E)
    return [m], V, bcs, problem(P, V, [m], bcs)


def plate_p2(P):
    """demos/plane_elastoplasticity.py's plate, 16x32 P2 quads (the port's
    banded route): bottom clamped, top pulled to 0.0075."""
    fem = P["fem"]
    V = fem.FunctionSpace(fem.create_rectangle((0, 0), (1.0, 2.0), (16, 32), "quad"), 2, (2,))
    bottom = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 0.0))
    top = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 1], 2.0), 1)
    bcs = [fem.DirichletBC(bottom, 0.0), fem.DirichletBC(top, 0.0075)]
    m = j2(P)
    prob = problem(P, V, [m], bcs)
    if P["pkg"] is tdm:
        assert prob.qmaps[0].domain.banded_active
    return [m], V, bcs, prob


def lifted_p2(V):
    """The uniform stretch u_y = 0.0075 y / 2: from zero displacement the
    whole increment sits in the top row of cells and neither package's
    Newton converges within its budget."""
    return np.stack([np.zeros(V.num_nodes), 0.0075 * V.node_coords[:, 1] / 2.0], axis=1).reshape(-1)


def p2_triangles(P):
    """P2 triangles, linear elasticity: the P2->P1 vertex coarse space."""
    fem = P["fem"]
    V = fem.FunctionSpace(fem.create_rectangle((0, 0), (1.0, 1.0), (6, 6), "triangle"), 2, (2,))
    m = P["pkg"].Material(P["models"].LinearElasticIsotropic(E, NU), **P["kw"])
    bcs = mech_bcs(P, V, 1e-3)
    return [m], V, bcs, problem(P, V, [m], bcs)


def esv_behaviors(P):
    """Two generic-path behaviors with external state variables: thermal
    expansion with a per-point constant temperature, and swelling driven by
    an expression of u (the displacement's first component, a coupling
    tangent block)."""
    base, xp, tn = P["base"], P["xp"], P["tensors"]
    lmbda, mu = E * NU / (1 + NU) / (1 - 2 * NU), E / 2 / (1 + NU)

    def elastic(e):
        return lmbda * tn.tr(e) * xp.asarray(tn.I2) + 2 * mu * e

    class ThermoElastic(base):
        external_state_variables = {"Temperature": 1}

        def init_state(self):
            return {"eps_th": np.zeros(())}

        def constitutive_update(self, inputs, state, dt):
            eth = 1e-5 * (inputs["Temperature"][0] - 293.0)
            return {"Stress": elastic(inputs["Strain"] - eth * xp.asarray(tn.I2))}, {"eps_th": eth}

    class Swelling(base):
        external_state_variables = {"Concentration": 1}
        extra_tangent_blocks = [("Stress", "Concentration")]

        def constitutive_update(self, inputs, state, dt):
            c = inputs["Concentration"][0]
            return {"Stress": elastic(inputs["Strain"] - 1e-3 * c * xp.asarray(tn.I2))}, state

    return ThermoElastic(), Swelling()


def esv(P):
    mesh = P["fem"].create_unit_square(4, 4, "quad")
    V = P["fem"].FunctionSpace(mesh, 1, (2,))
    cells = np.arange(mesh.num_cells)
    mats = [P["pkg"].Material(b, **P["kw"]) for b in esv_behaviors(P)]
    T = 293.0 + 50.0 * np.random.default_rng(3).random(8 * 4)  # 8 cells x 4 points
    bcs = mech_bcs(P, V, 1e-3)
    prob = problem(P, V, mats, bcs, cells=[cells[cells % 2 == 0], cells[cells % 2 == 1]],
                   esv=[(0, "Temperature", T), (1, "Concentration", lambda P: P["forms"].scalar_value())])
    return mats, V, bcs, prob


def rotated_call(V):
    """Per-call scales and an external force, seeded."""
    return dict(scales=[[0.8]], f_ext=1e-3 * np.random.default_rng(5).standard_normal(V.num_dofs))


CASES = {
    "two_materials": (two_materials, None, None, dict(n_newton=14, n_cg=300)),
    "rotated_scales_fext": (rotated, None, rotated_call, dict(n_newton=12, n_cg=200, smoother="block")),
    "unstructured_two_level": (delaunay, None, None, dict(n_newton=14, n_cg=140, pc="two_level")),
    "p2_plate_banded": (plate_p2, lifted_p2, None, dict(n_newton=12, n_cg=1000)),
    "p1_coarse": (p2_triangles, None, None, dict(n_newton=4, n_cg=300, cg_rtol=1e-10, coarse_modes="p1")),
    "esv_two_kinds": (esv, None, None, dict(n_newton=10, n_cg=200, pc="jacobi")),
}


@pytest.mark.parametrize("case", list(CASES))
def test_general_step_matches_jax(case):
    build, u0, call, opts = CASES[case]
    kw = {}
    if call is not None:
        V = build(PKGS["torch"])[1]
        kw = call(V)
    t = run("torch", build, u0, kw, **opts)
    j = run("jax", build, u0, kw, **opts)
    assert t[2] <= 1e-10 * t[3] + 1e-12, "the step must converge"
    assert_same(t, j)


def test_specialized_step_matches_jax_and_host_solver():
    """tests/test_sharding.py's 5x5 plate through make_sharded_newton_step:
    the port against the JAX step, and against its own host LU solve."""
    out = {}
    for which in ("torch", "jax"):
        P = PKGS[which]
        mats, V, bcs, prob = plate5(P)
        step, pad_state = P["par"].make_sharded_newton_step(
            prob.qmaps[0], prob, P["par"].device_mesh(1, **P["mesh_kw"]), n_newton=12, n_cg=200)
        mask, vals = P["combine"](bcs, V.num_dofs)
        u, st, rn = step(np.zeros(V.num_dofs), pad_state(mats[0].data_manager.s0.internal), mask, vals, 0.0)
        assert float(rn) < 1e-8 * E
        out[which] = np.asarray(u), np.asarray(st["p"]).ravel()
    (ut, pt), (uj, pj) = out["torch"], out["jax"]
    assert pj.max() > 1e-4
    np.testing.assert_allclose(ut, uj, rtol=0, atol=RTOL * np.abs(uj).max())
    np.testing.assert_allclose(pt, pj, rtol=0, atol=RTOL * pj.max())
    mats, V, bcs, host = plate5(PKGS["torch"])
    host.ksp_type = "lu"
    assert host.solve()[0]
    np.testing.assert_allclose(ut, host.u.x, rtol=1e-6, atol=1e-10)


def fefp_plate(P):
    """tests/test_sharding.py's finite-strain case: 5x5 P1 quads, FeFp J2
    with Voce hardening (identity-initialised be and F_prev), u_x = 2 sig0/E
    on the right edge."""
    fem, m = P["fem"], P["models"]
    V = fem.FunctionSpace(fem.create_unit_square(5, 5, "quad"), 1, (2,))
    mat = P["pkg"].Material(m.FeFpJ2Plasticity(m.LinearElasticIsotropic(E, NU), m.VoceHardening(SIG0, 500.0, 1e2)),
                            **P["kw"])
    q = P["pkg"].QuadratureMap(V, 2, mat)
    q.register_gradient("F", P["forms"].deformation_gradient_2d())
    bcs = mech_bcs(P, V, 2 * SIG0 / E)
    return [mat], V, bcs, P["pkg"].NonlinearMaterialProblem(q, fem.Function(V), bcs=bcs)


def test_fefp_specialized_step_matches_jax_host_solver():
    """The FeFp plate through the port's make_sharded_newton_step on one
    device (14 Newton x 200 CG) against the JAX package's host solve (LU),
    at tests/test_sharding.py's tolerances: u to rtol 1e-5 / atol 1e-9 and
    p to rtol 1e-5 / atol 1e-10, a finite residual below 1e-7 E, p > 1e-4
    somewhere. On one device no cell is padded; the padding is held over two
    ranks in tests/test_torch_multiprocess.py."""
    mats, V, bcs, host = fefp_plate(PKGS["jax"])
    host.ksp_type = "lu"
    assert host.solve()[0]
    u_ref = np.asarray(host.u.x)
    p_ref = np.asarray(mats[0].data_manager.s0["p"]).ravel()
    assert p_ref.max() > 1e-4

    mats, V, bcs, prob = fefp_plate(PKGS["torch"])
    step, pad_state = tpar.make_sharded_newton_step(prob.qmaps[0], prob, tpar.device_mesh(1, devices=["cpu"]),
                                                    n_newton=14, n_cg=200)
    st0 = pad_state(mats[0].data_manager.s0.internal)
    mask, vals = tcombine(bcs, V.num_dofs)
    u, st, rn = step(np.zeros(V.num_dofs), st0, mask, vals, 0.0)
    assert np.isfinite(float(rn)) and float(rn) < 1e-7 * E
    np.testing.assert_allclose(u.numpy(), u_ref, rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(st["p"].numpy().ravel()[: prob.qmaps[0].num_points], p_ref, rtol=1e-5, atol=1e-10)


PC_DT, PC_NX, PC_L = 2.0, 12, 0.1


def phase_change(P):
    """tests/test_sharding_general.py's transient case: a 12x1 strip of P1
    quads at Tm - 50, its left end held at Tm + 150, one implicit step of
    dt = 2 with the Enthalpy ISV in the residual, the conduction term scaled
    by a traced -dt and the previous enthalpy as the external force.
    Returns ``(material, V, bcs, T, problem, f_ext, Tm)``."""
    fem, forms = P["fem"], P["forms"]
    beh = P["models"].PhaseChangeHeatTransfer(Tsmooth=5.0, dim=2)
    mesh = fem.create_rectangle((0, 0), (PC_L, PC_L / PC_NX), (PC_NX, 1), "quad")
    V = fem.FunctionSpace(mesh, 1, ())
    mat = P["pkg"].Material(beh, **P["kw"])
    q = P["pkg"].QuadratureMap(V, 2, mat)
    q.register_gradient("TemperatureGradient", forms.scalar_gradient())
    q.register_external_state_variable("Temperature", forms.scalar_value())
    T = fem.Function(V)
    T.x[:] = beh.Tm - 50.0
    bcs = [fem.DirichletBC(fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0)), beh.Tm + 150.0)]
    prob = P["pkg"].NonlinearMaterialProblem(
        q, T, bcs=bcs,
        residual_terms=[[("Enthalpy", forms.scalar_value()), ("HeatFlux", forms.scalar_gradient(), lambda: -PC_DT)]],
        options={"ksp_type": "lu", "atol": 1e-4, "max_it": 60})
    q.update(P["xp"].asarray(T.x))
    q.advance()
    ext = q.domain.make_residual([forms.scalar_value()])
    f_ext = np.asarray(ext(P["xp"].asarray(T.x), [mat.data_manager.s0["Enthalpy"]]))
    return mat, V, bcs, T, prob, f_ext, beh.Tm


def test_transient_phase_change_matches_jax():
    """The transient phase change through make_sharded_newton_step_general
    (25 Newton x 300 CG, atol 1e-4): the port against the JAX fused step
    (u and the states to 1e-8 of their scale, equal Newton and CG counts,
    the entering residual to 1e-12) and against the JAX host solve (LU) at
    tests/test_sharding_general.py's tolerances, rtol 1e-5 / atol 1e-3; the
    front moved (a node above Tm)."""
    out = {}
    for which in ("torch", "jax"):
        P = PKGS[which]
        mat, V, bcs, T, prob, f_ext, Tm = phase_change(P)
        step, pad = P["par"].make_sharded_newton_step_general(prob, P["par"].device_mesh(1, **P["mesh_kw"]),
                                                              n_newton=25, n_cg=300, atol=1e-4, return_info="stats")
        mask, vals = P["combine"](bcs, V.num_dofs)
        u0 = np.array(T.x)
        u0[mask] = vals[mask]
        u, st, rn, rn0, (nn, ncg) = step(P["xp"].asarray(u0), pad([mat.data_manager.s0.internal]), mask, vals,
                                         PC_DT, f_ext=P["xp"].asarray(f_ext))
        out[which] = (np.asarray(u), [{k: np.asarray(v) for k, v in st[0].items()}], float(rn), float(rn0),
                      (int(nn), int(ncg)))
    assert out["torch"][2] < 2e-4
    assert_same(out["torch"], out["jax"])
    _, _, _, T, host, f_ext, Tm = phase_change(PKGS["jax"])
    host.external_force = f_ext
    assert host.solve()[0]
    np.testing.assert_allclose(out["torch"][0], T.x, rtol=1e-5, atol=1e-3)
    assert (out["torch"][0] > Tm).sum() >= 1


def test_tuple_axes_and_sharded_dofs_match_one_axis():
    """A ("dcn", "ici") mesh with shard_dofs=True gives the one-axis step's
    bits in the port, and the JAX step's results on the same mesh."""
    opts = dict(n_newton=12, n_cg=200)
    one = run("torch", plate5, **opts)
    out = {}
    for which in ("torch", "jax"):
        P = PKGS[which]
        mats, V, bcs, prob = plate5(P)
        step, pad = P["par"].make_sharded_newton_step_general(
            prob, P["par"].device_mesh((1, 1), ("dcn", "ici"), **P["mesh_kw"]), axis=("dcn", "ici"),
            shard_dofs=True, return_info="stats", **opts)
        mask, vals = P["combine"](bcs, V.num_dofs)
        u, st, rn, rn0, counts = step(np.zeros(V.num_dofs), pad([mats[0].data_manager.s0.internal]),
                                      mask, vals, 0.0)
        out[which] = (np.asarray(u), [{k: np.asarray(v) for k, v in st[0].items()}], float(rn), float(rn0),
                      tuple(int(c) for c in counts))
    np.testing.assert_array_equal(out["torch"][0], one[0])
    assert out["torch"][4] == one[4]
    assert_same(out["torch"], out["jax"])


def test_bench_configuration_at_8x8():
    """bench.py's fused-step configuration (6 Newton x 30 CG, two-level,
    right u_x = 2 sig0/E) on an 8x8 plate."""

    def build(P):
        V = P["fem"].FunctionSpace(P["fem"].create_unit_square(8, 8, "quad"), 1, (2,))
        bcs = mech_bcs(P, V, 2 * SIG0 / E)
        m = j2(P)
        return [m], V, bcs, problem(P, V, [m], bcs)

    opts = dict(n_newton=6, n_cg=30, pc="two_level")
    t, j = run("torch", build, **opts), run("jax", build, **opts)
    assert t[2] < 1e-10 * t[3] and j[2] < 1e-10 * j[3]
    assert_same(t, j)


def contrast_plate(inclusion):
    """8x8 P1 quads: a 1e5 matrix (nu 0.3) and a centred stiff inclusion
    (nu 0), left clamped, right pulled in x."""

    def build(P):
        fem, m = P["fem"], P["models"]
        mesh = fem.create_unit_square(8, 8, "quad")
        V = fem.FunctionSpace(mesh, 1, (2,))
        c = mesh.points[mesh.cells].mean(axis=1)
        incl = (np.abs(c[:, 0] - 0.5) < 0.2) & (np.abs(c[:, 1] - 0.5) < 0.2)
        cells = np.arange(mesh.num_cells)
        mats = [P["pkg"].Material(m.LinearElasticIsotropic(1e5, 0.3), **P["kw"]),
                P["pkg"].Material(m.LinearElasticIsotropic(inclusion, 0.0), **P["kw"])]
        left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
        right = [fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0), k) for k in (0, 1)]
        bcs = [fem.DirichletBC(left, 0.0), fem.DirichletBC(right[0], 1e-2), fem.DirichletBC(right[1], 0.0)]
        return mats, V, bcs, problem(P, V, mats, bcs, cells=[cells[~incl], cells[incl]])

    return build


MIXED = dict(n_newton=12, n_cg=200, cg_rtol=1e-5, precision="mixed", coarse_modes="rbm", agg_split_materials=True)


def test_mixed_precision_two_materials():
    """precision="mixed" (f64 residual, f32 tangent and CG on the scaled
    operator, f32 warmup) on the plate with a 1e10 inclusion, rigid-body
    coarse modes kept per material. The JAX package computes its "f32"
    tangent in float64 on the CPU (its Mandel constant is a numpy float64,
    which promotes under x64), so its CG runs in f64 and its counts are not
    the port's: u and state are held to 1e-8 of their scale, both steps
    reaching 1e-10 of the entering residual. The port's CG now follows the
    JAX package's dtype (see the 1e12 case below)."""
    build = contrast_plate(1e10)
    t, j = run("torch", build, **MIXED), run("jax", build, **MIXED)
    assert t[0].dtype == np.float64
    assert t[2] < 1e-10 * t[3] and j[2] < 1e-10 * j[3]
    assert_same(t, j, counts=False)


def test_mixed_precision_high_contrast_1e12():
    """precision="mixed" at a 1e12 inclusion in a 1e5 matrix, held against
    the unpatched JAX step run as tests/test_mixed_precision.py runs it. The
    JAX package's Mandel forms carry a numpy float64 sqrt(2), so under x64
    its "f32" tangent and CG are float64; the port gives Mandel kinematics
    the same float64 tangent and CG, and its warmup the same f32 u and
    residual over float64 element kernels (fem.forms.mixed_tangent_dtype).
    Both reach a relative residual below 1e-8 and agree on u to 1e-6. Both
    spend their Newton budget at the residual floor (~5e-10, above rtol =
    1e-10), where the CG runs its 200-iteration budget: 14 Newton and 2,053
    CG iterations here against 2,055, so the counts are not compared."""
    build = contrast_plate(1e12)
    t, j = run("torch", build, **MIXED), run("jax", build, **MIXED)
    assert t[2] < 1e-8 * t[3] and j[2] < 1e-8 * j[3]
    np.testing.assert_allclose(t[0], j[0], rtol=0, atol=1e-6 * np.abs(j[0]).max())

    P = PKGS["torch"]
    mats, V, bcs, prob = build(P)
    step, pad = tpar.make_sharded_newton_step_general(prob, tpar.device_mesh(1, devices=["cpu"]), **MIXED)
    mask, vals = tcombine(bcs, V.num_dofs)
    step(np.zeros(V.num_dofs), pad([m.data_manager.s0.internal for m in mats]), mask, vals, 0.0)
    # the JAX package's tangent dtype on this problem: the variation of its
    # Mandel strain at float32 inputs
    ctx = jforms.Ctx(jnp.zeros(2, jnp.float32), jnp.zeros((2, 2), jnp.float32), jnp.zeros(2, jnp.float32))
    _, dstrain = jax.jvp(lambda g: jforms.mandel_strain_2d()(ctx._replace(grad=g)), (ctx.grad,),
                         (jnp.ones((2, 2), jnp.float32),))
    assert str(step.info["cg_dtype"]).split(".")[-1] == str(dstrain.dtype) == "float64"


def test_mixed_tangent_dtype_follows_the_kinematics():
    """The rule of ``precision="mixed"``: float64 tangents and CG for Mandel
    strains, float32 for deformation gradients and untagged expressions."""
    f = tforms
    assert f.mixed_tangent_dtype([f.mandel_strain_2d()]) == torch.float64
    assert f.mixed_tangent_dtype([f.mandel_strain(3), f.scalar_value()]) == torch.float64
    assert f.mixed_tangent_dtype([f.deformation_gradient(3)]) == torch.float32
    assert f.mixed_tangent_dtype([f.deformation_gradient_2d(), lambda ctx: ctx.u]) == torch.float32


# ------------------------------------------------------- pieces of the step
def test_masked_cg_blocks_match_the_plain_early_exit_loop():
    """Masked blocks of 16 iterations against the unmasked loop with one
    host test an iteration: bitwise equal x and iteration counts, for a
    budget that ends the loop mid-block and a tolerance that does."""
    rng = np.random.default_rng(0)
    n = 60
    A = rng.standard_normal((n, n))
    A = torch.as_tensor(A @ A.T + n * np.eye(n))
    d = torch.diagonal(A).clone()
    b = torch.as_tensor(rng.standard_normal(n))
    ops = {"A": A, "d": d}

    def Av(o, v):
        return o["A"] @ v

    def M(o, r):
        return r / o["d"]

    def plain(n_cg, cg_rtol):
        x, r = torch.zeros_like(b), b
        z = M(ops, r)
        p, rz = z, torch.dot(r, z)
        tol2 = cg_rtol * cg_rtol * rz.abs()
        k = 0
        zero = torch.zeros((), dtype=b.dtype)
        while k < n_cg and float(rz.abs()) > float(tol2):
            Ap = Av(ops, p)
            den = torch.dot(p, Ap)
            alpha = torch.where(den.abs() > 1e-30, rz / den, zero)
            x = x + alpha * p
            r = r - alpha * Ap
            z = M(ops, r)
            rz_new = torch.dot(r, z)
            beta = torch.where(rz.abs() > 1e-30, rz_new / rz, zero)
            p, rz = p * beta + z, rz_new
            k += 1
        return x, k

    for n_cg, cg_rtol in ((21, 1e-14), (500, 1e-6), (500, 1e-12)):
        cg = MaskedCG(Av, M, n_cg, cg_rtol)
        x, k = cg.solve(ops, b)
        x_ref, k_ref = plain(n_cg, cg_rtol)
        assert k == k_ref and cg.blocks == max(1, -(-k // 16))
        assert torch.equal(x, x_ref)
    assert k_ref < 500


def test_device_mesh_and_helpers():
    mesh = tpar.device_mesh(1, devices=["cpu"])
    assert mesh.size == 1 and mesh.device == torch.device("cpu") and mesh.shape == {"cells": 1}
    two = tpar.device_mesh((1, 1), ("dcn", "ici"), devices=["cpu"])
    assert two.shape == {"dcn": 1, "ici": 1}
    with pytest.raises(RuntimeError, match="multiprocess.initialize"):
        tpar.device_mesh(2, devices=["cpu", "cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tpar.device_mesh(1)
    a = np.arange(10.0).reshape(5, 2)
    for arr in (a, torch.as_tensor(a)):
        padded, n = tpar.pad_to_multiple(arr, 4, fill=-1)
        jp, jn = jpar.pad_to_multiple(np.asarray(arr), 4, fill=-1)
        assert n == jn == 5 and type(padded) is type(arr)
        np.testing.assert_array_equal(np.asarray(padded), jp)


def test_constitutive_update_matches_jax():
    """make_sharded_constitutive_update: the generic per-point update of a
    seeded strain batch, against the JAX kernel on one device."""
    n = 64
    eps = np.random.default_rng(0).normal(size=(n, 6)) * 2e-2
    out = {}
    for which in ("torch", "jax"):
        P = PKGS[which]
        m = j2(P)
        m.set_data_manager(n)
        upd = P["par"].make_sharded_constitutive_update(m, P["par"].device_mesh(1, **P["mesh_kw"]))
        flux, Ct, st = upd(eps if which == "torch" else jnp.asarray(eps), m.data_manager.s0.internal, 0.0)
        out[which] = [np.asarray(a) for a in (flux, Ct, st["p"])]
    for a, b in zip(out["torch"], out["jax"]):
        np.testing.assert_allclose(a.reshape(b.shape), b, rtol=1e-10, atol=1e-10 * np.abs(b).max())


def test_step_raises_for_a_problem_off_the_mesh_device():
    P = PKGS["torch"]
    _, _, _, prob = plate5(P)
    meta = tpar.device_mesh(1, devices=["meta"])
    with pytest.raises(ValueError, match="mesh on meta"):
        tpar.make_sharded_newton_step_general(prob, meta)


def test_importing_the_port_loads_no_jax():
    """A fresh interpreter that imports the port and every submodule,
    parallel included, has neither jax nor the JAX package loaded."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import dolfinx_materials_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import dolfinx_materials_tpu_torch.parallel\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'dolfinx_materials_tpu.'))\n"
        "             or k == 'dolfinx_materials_tpu')\n"
        "assert 'dolfinx_materials_tpu_torch.parallel.sharding' in sys.modules\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(__import__("pathlib").Path(__file__).resolve().parent.parent))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
