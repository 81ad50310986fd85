"""The demo twins of dolfinx_materials_tpu_torch/demos against the JAX
package's demos (demos/*.py), on the CPU in float64 at the small sizes of
tests/test_demos_smoke.py, each run in ``tmp_path``:

- plane_elastoplasticity at N = 6: the same accepted load steps, reaction
  forces to 1e-8, the same VTK file but for its title line;
- curved_cylinder at N = 3: displacements of both variants to 1e-10 and the
  same Lamé errors;
- hyperelasticity at N = 2: the same accepted steps, u to 1e-8;
- custom_behavior at N = 2: the relaxation stresses to 1e-8;
- finite_strain_elastoplasticity at N = 2: the same accepted steps, u to
  1e-8, max p and mean PK1_xx as the JAX demo prints them;
- heat_transfer (stationary at nx = 16, phase change at nx = 24 over 4
  steps) and thermomechanics at N = 6: the printed summaries equal, T, u
  to 1e-10 (tests/test_torch_thermal.py holds the fields in detail);
- conic_return_mapping at n_dirs = 6: the CSV, and the final stresses of
  the Rankine materials against the JAX demo's ``stress_paths`` to 1e-10 of
  the yield scale;
- nn_surrogate at 300 steps: the loss history to 1e-8 relative, the
  displacement error to 1e-6 relative;
- multimaterial_interface at its defaults (20 x 10 P1): the same Newton
  count, the matrix's p max to 1e-8 relative, the interface jump and both
  fields to 1e-8 of their scale;
- sharded_scaling at two ranks (gloo, two processes) and N = 8: u and p to
  1e-8 of their scale against the JAX demo's step on two devices.
"""

import importlib.util
import os
import pathlib

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

import jax  # noqa: E402, F401

from dolfinx_materials_tpu_torch.demos import (  # noqa: E402
    conic_return_mapping,
    curved_cylinder,
    custom_behavior,
    finite_strain_elastoplasticity,
    heat_transfer,
    hyperelasticity,
    multimaterial_interface,
    nn_surrogate,
    plane_elastoplasticity,
    sharded_scaling,
    thermomechanics,
)

torch.set_num_threads(1)
DEMO_DIR = pathlib.Path(__file__).parent.parent / "demos"


def load(stem):
    spec = importlib.util.spec_from_file_location(f"jax_demo_{stem}", DEMO_DIR / f"{stem}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def recording(mod, monkeypatch):
    """Make the JAX demo keep every problem it builds (its mains return no
    displacement)."""
    problems = []

    class Recording(mod.NonlinearMaterialProblem):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            problems.append(self)

    monkeypatch.setattr(mod, "NonlinearMaterialProblem", Recording)
    return problems


def rel(got, want):
    got, want = np.asarray(got, dtype=float), np.asarray(want, dtype=float)
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_plane_elastoplasticity_matches_jax(tmp_path, monkeypatch):
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    load("plane_elastoplasticity").main(N=6)
    want = np.loadtxt(tmp_path / "jax" / "plane_elastoplasticity_force.csv")
    out = plane_elastoplasticity.main(N=6, device="cpu", out_dir=str(tmp_path))
    assert out["steps"] == want[:, 0].tolist()
    assert rel(out["forces"], want[:, 1]) <= 1e-8
    got = np.loadtxt(tmp_path / "plane_elastoplasticity_force.csv")
    assert rel(got[:, 1], want[:, 1]) <= 1e-8
    assert out["max_p"] > 0.01  # the plate yields
    a = (tmp_path / "plane_elastoplasticity.vtk").read_text().split("\n")
    b = (tmp_path / "jax" / "plane_elastoplasticity.vtk").read_text().split("\n")
    assert a[1] == "dolfinx_materials_tpu_torch" and a[:1] + a[2:] == b[:1] + b[2:]


def test_curved_cylinder_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mod = load("curved_cylinder")
    problems = recording(mod, monkeypatch)
    for curved in (False, True):
        want_err = mod.solve_annulus(3, curved)
        err, u = curved_cylinder.solve_annulus(3, curved, device="cpu")
        assert rel(u, problems[-1].u.x) <= 1e-10
        assert abs(err - want_err) <= 1e-10 * want_err
    errors = curved_cylinder.main(N=3, device="cpu")
    assert set(errors) == {"straight", "curved"}


def test_hyperelasticity_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mod = load("hyperelasticity")
    problems = recording(mod, monkeypatch)
    mod.main(N=2)
    accepted, u = hyperelasticity.main(N=2, device="cpu")
    assert accepted[-1] == pytest.approx(0.2)
    assert np.abs(u).max() > 0.1
    assert rel(u, problems[-1].u.x) <= 1e-8


def test_custom_behavior_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    ts_j, sig_j, analytic_j, _ = load("custom_behavior").main(N=2, n_hold=4)
    ts, sig, analytic, err = custom_behavior.main(N=2, n_hold=4, device="cpu", out_dir=str(tmp_path))
    np.testing.assert_array_equal(ts, ts_j)
    np.testing.assert_array_equal(analytic, analytic_j)
    assert rel(sig, sig_j) <= 1e-8
    assert err <= 1e-10  # the closed form
    assert (tmp_path / "zener_relaxation.csv").exists()


def test_finite_strain_elastoplasticity_matches_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    mod = load("finite_strain_elastoplasticity")
    problems = recording(mod, monkeypatch)
    mod.main(N=2)
    jax_out = capsys.readouterr().out.splitlines()[-1]
    out = finite_strain_elastoplasticity.main(N=2, device="cpu", out_dir=str(tmp_path))
    assert out["steps"][-1] == pytest.approx(0.05 * 3.0)
    assert f"max p = {out['max_p']:.4f}; mean PK1_xx = {out['mean_pk1_xx']:.1f}" in jax_out
    assert jax_out.startswith(f"{len(out['steps'])} steps")
    assert rel(out["qmap"].material.data_manager.s0["PK1"], problems[-1].qmaps[0].material.data_manager.s0["PK1"]) \
        <= 1e-8
    assert out["max_p"] > 0.0


def test_heat_transfer_and_thermomechanics_match_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    heat = load("heat_transfer")
    heat.stationary(nx=16)
    heat.phase_change(nx=24, nsteps=4)
    thermo = load("thermomechanics")
    problems = recording(thermo, monkeypatch)
    thermo.main(N=6)
    jax_lines = capsys.readouterr().out.splitlines()
    st = heat_transfer.stationary(nx=16, device="cpu")
    ph = heat_transfer.phase_change(nx=24, nsteps=4, device="cpu", out_dir=str(tmp_path))
    tm = thermomechanics.main(N=6, device="cpu", out_dir=str(tmp_path))
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == jax_lines[0] and lines[1] == jax_lines[1]  # the two heat summaries
    assert lines[-1] == jax_lines[-1].replace(", wrote thermomechanics.vtk", "")
    assert st["flux_err"] < 2e-3 and ph["fronts"][-1] > 0
    assert rel(tm["T"], problems[0].u.x) <= 1e-10 and rel(tm["u"], problems[1].u.x) <= 1e-10


def test_conic_return_mapping_matches_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    mod = load("conic_return_mapping")
    finals = conic_return_mapping.main(n_dirs=6, device="cpu", out_dir=str(tmp_path))
    got = np.loadtxt(tmp_path / "conic_stress_paths.csv", delimiter=",")
    assert got.shape == (3 * 6 * 24, 6)
    for m, (name, fin) in enumerate(finals.items()):
        np.testing.assert_allclose(got[got[:, 0] == m][23::24, 3:], fin, rtol=0, atol=0)
        if name == "vonmises_ps":  # its paths: tests/test_torch_conic_exact.py at n_dirs = 4
            continue
        mat = getattr(mod, {"rankine": "RankineExact", "l1rankine": "L1RankineExact",
                            "vonmises_ps": "PlaneStressVonMisesExact"}[name])
        args = (mod.E, mod.nu, mod.ft, mod.fc) if name != "vonmises_ps" else (mod.E, mod.nu, mod.sig0)
        want = mod.stress_paths(mat(*args), n_dirs=6)[:, -1]
        assert np.abs(fin - want).max() <= 1e-10 * mod.fc


def test_nn_surrogate_matches_jax(monkeypatch, capsys):
    mod = load("nn_surrogate")
    problems = recording(mod, monkeypatch)
    fits = []
    fit = mod.NeuralBehavior.fit

    def keep(self, *a, **k):
        fits.append(fit(self, *a, **k))
        return fits[-1]

    monkeypatch.setattr(mod.NeuralBehavior, "fit", keep)
    mod.main(steps=300)
    out = nn_surrogate.main(steps=300, device="cpu")
    assert np.abs(np.array(out["history"]) / np.array(fits[0]) - 1.0).max() <= 1e-8
    assert rel(out["u"], problems[0].u.x) <= 1e-6
    assert out["history"][-1] < out["history"][0]


def test_multimaterial_interface_matches_jax(monkeypatch):
    mod = load("multimaterial_interface")
    problems = recording(mod, monkeypatch)
    its_j, p_j, jump_j = mod.main()
    its, p_max_m, jump = multimaterial_interface.main(device="cpu")
    assert its == its_j
    assert abs(p_max_m - p_j) <= 1e-8 * p_j and p_max_m > 1e-4
    assert rel(jump, jump_j) <= 1e-8
    b = multimaterial_interface.build(device="cpu")
    assert b["blocked"].solve() == (True, its)
    for got, want in zip(b["problems"], problems):
        assert rel(got.u.x, want.u.x) <= 1e-8


def test_sharded_scaling_matches_jax(monkeypatch):
    """The twin at two ranks on the CPU (gloo) against the JAX demo on two
    virtual devices, the size tests/test_demos_smoke.py runs."""
    mod = load("sharded_scaling")
    outs = []

    def recording_step(*args, **kwargs):
        step, pad = make(*args, **kwargs)

        def rec(*a):
            outs.append(step(*a))
            return outs[-1]

        return rec, pad

    make = mod.make_sharded_newton_step
    monkeypatch.setattr(mod, "make_sharded_newton_step", recording_step)
    mod.run(2, N=8)
    u_j, st_j, rn_j = outs[-1]
    got = sharded_scaling.run(2, N=8, device="cpu", reps=0)
    assert rel(got["u"], u_j) <= 1e-8
    assert rel(got["p"], np.asarray(st_j["p"]).reshape(-1)) <= 1e-8
    assert got["res"] < 1e-8 * sharded_scaling.E and float(rn_j) < 1e-8 * sharded_scaling.E
