"""The port's thermal behaviors (``models/thermal.py``) and their demo
twins against the JAX package's, in float64 on the CPU:

- the four behaviors through ``Material`` at random points made from a
  numpy seed: fluxes, internal state and every tangent block to 1e-12 of
  scale;
- the stationary and phase-change twins of demos/heat_transfer.py at the
  smoke sizes of tests/test_demos_smoke.py: T to 1e-10 of scale, the same
  Newton count and flux error to 1e-10, the fronts equal;
- the phase-change front against tests/golden/phase_change_code_Aster.csv
  with tests/test_golden_reference.py's bars (front 1.5 mm, mean 1 K,
  pointwise 6 K);
- the thermomechanics twin against demos/thermomechanics.py at N = 6: T, u
  and stresses to 1e-10 of scale;
- the fused step with the thermal external state variable on
  ``device_mesh(1)`` against the JAX case of tests/test_sharding_general.py
  (10 x 3 mesh): u to 1e-8 against the JAX fused step and the host solve.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import dolfinx_materials_tpu as jdm  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.demos import heat_transfer, thermomechanics  # noqa: E402

torch.set_num_threads(1)
ROOT = pathlib.Path(__file__).parent.parent


def load(stem):
    spec = importlib.util.spec_from_file_location(f"jax_demo_{stem}", ROOT / "demos" / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def close(a, b, tol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300))


BEHAVIORS = {
    "nonlinear_heat": lambda m: m.NonlinearHeatTransfer(dim=2),
    "thermo_elastic": lambda m: m.ThermoElasticIsotropic(70e3, 0.3, 1e-5),
    "phase_change": lambda m: m.PhaseChangeHeatTransfer(Tsmooth=5.0, dim=2),
    "thermo_mechanical_heat": lambda m: m.ThermoMechanicalHeat(k=2.0, kappa=0.5, chi=3.0, dim=2),
}


@pytest.mark.parametrize("name", sorted(BEHAVIORS))
def test_behavior_matches_jax(name):
    n = 16
    rng = np.random.default_rng(0)
    mt = tdm.Material(BEHAVIORS[name](tmodels), device="cpu")
    mj = jdm.Material(BEHAVIORS[name](jmodels))
    assert mt._fast_update is None
    grads = rng.normal(size=(n, sum(mt.gradients.values())))
    mt.set_data_manager(n)
    mj.set_data_manager(n)
    for esv in mt.external_state_variables:
        # temperatures across the phase-change interval (Tm = 933.15, Tsmooth = 5)
        v = 933.15 + 10.0 * rng.uniform(-1, 1, size=n) if esv == "Temperature" else 1e-3 * rng.normal(size=n)
        mt.update_external_state_variable(esv, v)
        mj.update_external_state_variable(esv, v)
    ft, it, Ct = mt.integrate(grads)
    fj, ij, Cj = mj.integrate(jnp.asarray(grads))
    assert tuple(Ct.shape) == tuple(Cj.shape)
    close(ft, fj, 1e-12)
    close(Ct, Cj, 1e-12)
    if it.shape[1]:
        close(it, ij, 1e-12)
    if name == "phase_change":  # the three branches all ran
        T = mt.external_state["Temperature"].numpy()
        assert (T < 930.65).any() and (T > 935.65).any() and ((T > 930.65) & (T < 935.65)).any()


def test_stationary_twin_matches_jax(capsys):
    out = heat_transfer.stationary(nx=16, device="cpu")
    mod = load("heat_transfer")
    problems = []

    class Recording(mod.NonlinearMaterialProblem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            problems.append(self)

    mod.NonlinearMaterialProblem = Recording
    mod.stationary(nx=16)
    assert f"flux error {out['flux_err']:.2e}" in capsys.readouterr().out.splitlines()[-1]
    close(out["T"], problems[-1].u.x, 1e-10)
    assert out["iterations"] == problems[-1].iterations
    assert out["flux_err"] < 2e-3


def test_phase_change_twin_matches_jax(tmp_path, monkeypatch):
    out = heat_transfer.phase_change(nx=24, nsteps=4, device="cpu", out_dir=str(tmp_path))
    mod = load("heat_transfer")
    problems = []

    class Recording(mod.NonlinearMaterialProblem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            problems.append(self)

    mod.NonlinearMaterialProblem = Recording
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    mod.phase_change(nx=24, nsteps=4)
    close(out["T"], problems[-1].u.x, 1e-10)
    assert out["fronts"][-1] > 0.0 and (np.diff(out["fronts"]) >= 0).all()
    text = (tmp_path / "phase_change.pvd").read_text()
    assert text.count("<DataSet") == 5
    for i in range(5):
        a = (tmp_path / f"phase_change_{i:04d}.vtk").read_text().split("\n")
        b = (tmp_path / "jax" / f"phase_change_{i:04d}.vtk").read_text().split("\n")
        assert a[:1] + a[2:] == b[:1] + b[2:]


def test_phase_change_vs_code_aster_golden():
    """tests/test_golden_reference.py's code_Aster TTNL02 case, on the port."""
    from dolfinx_materials_tpu_torch.fem import (
        DirichletBC, Function, FunctionSpace, create_rectangle, locate_dofs_geometrical)
    from dolfinx_materials_tpu_torch.fem.forms import scalar_gradient, scalar_value

    beh = tmodels.PhaseChangeHeatTransfer(Tsmooth=1.0, dim=2)
    length, nx = 0.1, 400
    mesh = create_rectangle((0, 0), (length, length / nx), (nx, 1), "quad")
    V = FunctionSpace(mesh, 1, ())
    mat = tdm.Material(beh, device="cpu")
    qmap = tdm.QuadratureMap(V, 2, mat)
    qmap.register_gradient("TemperatureGradient", scalar_gradient())
    qmap.register_external_state_variable("Temperature", scalar_value())
    Tl, Tr = 853.15, 1013.15
    T = Function(V)
    T.x[:] = Tr
    left = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
    right = locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], length))
    nsteps = 60
    dtv = 6.0 / nsteps
    problem = tdm.NonlinearMaterialProblem(
        qmap, T, bcs=[DirichletBC(left, Tl), DirichletBC(right, Tr)],
        residual_terms=[[("Enthalpy", scalar_value()), ("HeatFlux", scalar_gradient(), lambda: -dtv)]],
        options={"ksp_type": "lu", "atol": 1e-2, "rtol": 1e-10, "max_it": 60})
    qmap.update(T.x)
    qmap.advance()
    ext = qmap.domain.make_residual([scalar_value()])

    gold = np.loadtxt(ROOT / "tests" / "golden" / "phase_change_code_Aster.csv", delimiter=",")
    x_gold = gold[:, 0]
    x_nodes = V.node_coords[:, 0]
    row = np.isclose(V.node_coords[:, 1], 0.0)
    order = np.argsort(x_nodes[row])
    Tm_C = beh.Tm - 273.15

    def front_pos(xv, T_C):
        i = np.argmax(T_C > Tm_C)
        if i == 0:
            return 0.0
        x0, x1, t0, t1 = xv[i - 1], xv[i], T_C[i - 1], T_C[i]
        return x0 + (Tm_C - t0) / (t1 - t0) * (x1 - x0)

    worst_T = worst_front = worst_mean = 0.0
    for k in range(nsteps):
        problem.external_force = ext(torch.as_tensor(T.x), [mat.data_manager.s0["Enthalpy"]])
        converged, _ = problem.solve()
        assert converged, f"transient step {k} failed"
        t = (k + 1) * dtv
        it = int(round(t))
        if np.isclose(t, it) and 1 <= it <= 6:
            xv = x_nodes[row][order]
            T_C = np.asarray(T.x)[row][order] - 273.15
            d = np.abs(np.interp(x_gold, xv, T_C) - gold[:, it])
            worst_T, worst_mean = max(worst_T, d.max()), max(worst_mean, d.mean())
            worst_front = max(worst_front, abs(front_pos(xv, T_C) - front_pos(x_gold, gold[:, it])))
    assert worst_front < 1.5e-3, f"front position off by {worst_front * 1e3:.2f} mm"
    assert worst_mean < 1.0, f"mean |T - code_Aster| = {worst_mean:.2f} K"
    assert worst_T < 6.0, f"max |T - code_Aster| = {worst_T:.2f} K"


def test_thermomechanics_twin_matches_jax(tmp_path, monkeypatch):
    out = thermomechanics.main(N=6, device="cpu", out_dir=str(tmp_path))
    mod = load("thermomechanics")
    problems = []

    class Recording(mod.NonlinearMaterialProblem):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            problems.append(self)

    mod.NonlinearMaterialProblem = Recording
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    mod.main(N=6)
    heat, mech = problems
    close(out["T"], heat.u.x, 1e-10)
    close(out["u"], mech.u.x, 1e-10)
    close(out["stress"], mech.qmaps[0].material.data_manager.s0["Stress"], 1e-10)
    assert out["iterations"] == (heat.iterations, mech.iterations)
    assert out["stress"][:, 0].min() < 0


def test_fused_step_thermal_esv_matches_jax():
    """tests/test_sharding_general.py's thermal case on one device."""
    from dolfinx_materials_tpu import fem as jfem
    from dolfinx_materials_tpu import parallel as jpar
    from dolfinx_materials_tpu.fem.forms import scalar_gradient as jsg, scalar_value as jsv

    from dolfinx_materials_tpu_torch import fem as tfem
    from dolfinx_materials_tpu_torch import parallel as tpar
    from dolfinx_materials_tpu_torch.fem.bc import combine_bcs
    from dolfinx_materials_tpu_torch.fem.forms import scalar_gradient as tsg, scalar_value as tsv

    A, B, T0, T1 = 0.0375, 2.165e-4, 300.0, 800.0

    def build(pkg, fem, models, sg, sv, **kw):
        mesh = fem.create_rectangle((0, 0), (1.0, 0.2), (10, 3), "quad")
        V = fem.FunctionSpace(mesh, 1, ())
        mat = pkg.Material(models.NonlinearHeatTransfer(A=A, B=B, dim=2), **kw)
        qmap = pkg.QuadratureMap(V, 2, mat)
        qmap.register_gradient("TemperatureGradient", sg())
        qmap.register_external_state_variable("Temperature", sv())
        left = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 0.0))
        right = fem.locate_dofs_geometrical(V, lambda x: np.isclose(x[:, 0], 1.0))
        bcs = [fem.DirichletBC(left, T0), fem.DirichletBC(right, T1)]
        T = fem.Function(V)
        T.x[:] = T0
        prob = pkg.NonlinearMaterialProblem(qmap, T, bcs=bcs, residual_terms=[[("HeatFlux", sg())]],
                                            options={"ksp_type": "lu", "atol": 1e-8})
        return mat, V, bcs, T, prob

    mat, V, bcs, T, prob = build(tdm, tfem, tmodels, tsg, tsv, device="cpu")
    host = build(tdm, tfem, tmodels, tsg, tsv, device="cpu")
    assert host[4].solve()[0]
    step, pad = tpar.make_sharded_newton_step_general(prob, tpar.device_mesh(1, devices=["cpu"]), n_newton=12,
                                                      n_cg=200)
    mask, vals = combine_bcs(bcs, V.num_dofs)
    u0 = np.full(V.num_dofs, T0)
    u0[mask] = vals[mask]
    u, _, rn = step(u0, pad([mat.data_manager.s0.internal]), mask, vals, 0.0)
    assert float(rn) < 1e-8 * T1

    jmat, jV, jbcs, _, jprob = build(jdm, jfem, jmodels, jsg, jsv)
    jstep, _ = jpar.make_sharded_newton_step_general(jprob, jpar.device_mesh(1), n_newton=12, n_cg=200)
    jmask, jvals = jfem.bc.combine_bcs(jbcs, jV.num_dofs)
    uj, _, _ = jstep(jnp.asarray(u0), [jmat.data_manager.s0.internal], jmask, jvals, 0.0)
    np.testing.assert_allclose(np.asarray(u), np.asarray(uj), rtol=1e-8, atol=1e-8)
    np.testing.assert_allclose(np.asarray(u), host[3].x, rtol=1e-8, atol=1e-8)
