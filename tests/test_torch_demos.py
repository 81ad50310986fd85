"""The four demo twins of dolfinx_materials_tpu_torch/demos against the JAX
package's demos (demos/*.py), on the CPU in float64 at the small sizes of
tests/test_demos_smoke.py, each run in ``tmp_path``:

- plane_elastoplasticity at N = 6: the same accepted load steps, reaction
  forces to 1e-8, the same VTK file but for its title line;
- curved_cylinder at N = 3: displacements of both variants to 1e-10 and the
  same Lamé errors;
- hyperelasticity at N = 2: the same accepted steps, u to 1e-8;
- custom_behavior at N = 2: the relaxation stresses to 1e-8.
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
    curved_cylinder,
    custom_behavior,
    hyperelasticity,
    plane_elastoplasticity,
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
