"""The port's exact conic projections (``models/conic_exact.py``) against
the JAX package's, in float64 on the CPU:

- the four projections on 64 random trial stresses (numpy seed) to 1e-10
  of the yield scale, and their consistent tangents (``jacfwd`` of the
  update) at plastic points to 1e-9 of the tangent's scale;
- the golden file tests/golden/conic_projection.csv to tests/test_conic_exact.py's
  bar (1e-8 of the yield scale);
- ``tangent="elastic"``: a ``torch.func.jvp`` of the update gives C dv,
  the detached projection dropping its tangent as ``lax.stop_gradient``
  does;
- ``stress_paths`` of the demo twin at ``n_dirs=4`` against the JAX demo's
  to 1e-10.
"""

import importlib.util
import os
import pathlib

import numpy as np
import pytest
import torch
from torch.func import jacfwd, jvp, vmap

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402

from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.demos import conic_return_mapping  # noqa: E402

torch.set_num_threads(1)
E, nu, ft, fc = 30e3, 0.2, 3.0, 30.0
ROOT = pathlib.Path(__file__).parent.parent

MATS = {
    "rankine": lambda m: m.RankineExact(E, nu, ft, fc),
    "l1rankine": lambda m: m.L1RankineExact(E, nu, ft, fc),
    "hosford": lambda m: m.HosfordExact(E, nu, 3.0, 10.0),
    "vonmises_ps": lambda m: m.PlaneStressVonMisesExact(E, nu, 5.0),
}


def close(a, b, tol, scale):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("name", sorted(MATS))
def test_projection_and_tangent_match_jax(name):
    mt, mj = MATS[name](tmodels), MATS[name](jmodels)
    rng = np.random.default_rng(3)
    trials = rng.normal(size=(64, 3)) * 50.0
    trials[0] = [0.5, -1.0, 0.3]  # inside every surface
    trials[1] = [50.0, 50.0, 0.0]  # towards the biaxial vertex
    got = vmap(mt.project)(torch.tensor(trials))
    want = jax.vmap(mj.project)(jnp.asarray(trials))
    scale = max(mt.ft, mt.fc)
    close(got, want, 1e-10, scale)
    np.testing.assert_allclose(got[0].numpy(), trials[0], atol=1e-12)

    state_t, state_j = mt.init_state(), mj.init_state()
    eps = rng.normal(size=(8, 3)) * 4e-4

    def ft_(e):
        return mt.constitutive_update({"Strain": e}, {k: torch.as_tensor(v) for k, v in state_t.items()}, 0.0)[0][
            "Stress"]

    def fj_(e):
        return mj.constitutive_update({"Strain": e}, state_j, 0.0)[0]["Stress"]

    Ct = vmap(jacfwd(ft_))(torch.tensor(eps))
    Cj = jax.vmap(jax.jacfwd(fj_))(jnp.asarray(eps))
    close(Ct, Cj, 1e-9, float(np.abs(np.asarray(Cj)).max()))
    plastic = np.abs(np.asarray(vmap(ft_)(torch.tensor(eps))) - eps @ mt.C.T).max(axis=1) > 1e-6
    assert plastic.any()


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_golden(kind):
    gold = np.loadtxt(ROOT / "tests" / "golden" / "conic_projection.csv", delimiter=",")
    rows = gold[gold[:, 0] == kind]
    mat = (tmodels.RankineExact(E, nu, ft, fc), tmodels.L1RankineExact(E, nu, ft, fc),
           tmodels.HosfordExact(E, nu, 3.0, 10.0))[kind]
    got = vmap(mat.project)(torch.tensor(rows[:, 1:4])).numpy()
    err = np.abs(got - rows[:, 4:7]).max()
    assert err <= 1e-8 * (max(ft, fc) if kind < 2 else 3.0), f"max projection error {err:.3e}"


def test_vertex_exactness():
    mat = tmodels.RankineExact(E, nu, ft, fc)
    np.testing.assert_allclose(mat.project(torch.tensor([50.0, 50.0, 0.0])).numpy(), [ft, ft, 0.0], atol=1e-10)
    np.testing.assert_allclose(mat.project(torch.tensor([-500.0, -500.0, 0.0])).numpy(), [-fc, -fc, 0.0],
                               atol=1e-9)


@pytest.mark.parametrize("name", sorted(MATS))
def test_elastic_tangent_drops_projection(name):
    mt, mj = MATS[name](tmodels), MATS[name](jmodels)
    mt.tangent = mj.tangent = "elastic"
    eps = np.array([4e-4, 1e-4, 2e-4])  # plastic on every surface
    v = np.array([0.3, -0.2, 0.5])
    st = {k: torch.as_tensor(x) for k, x in mt.init_state().items()}
    ft_ = lambda e: mt.constitutive_update({"Strain": e}, st, 0.0)[0]["Stress"]  # noqa: E731
    fj_ = lambda e: mj.constitutive_update({"Strain": e}, mj.init_state(), 0.0)[0]["Stress"]  # noqa: E731
    s_t, ds_t = jvp(ft_, (torch.tensor(eps),), (torch.tensor(v),))
    s_j, ds_j = jax.jvp(fj_, (jnp.asarray(eps),), (jnp.asarray(v),))
    np.testing.assert_allclose(ds_t.numpy(), mt.C @ v, rtol=1e-14)
    close(ds_t, ds_j, 1e-12, float(np.abs(mt.C @ v).max()))
    close(s_t, s_j, 1e-10, max(mt.ft, mt.fc))
    assert np.abs(s_t.numpy() - mt.C @ eps).max() > 1e-3  # the value is the projection


def test_stress_paths_match_jax():
    spec = importlib.util.spec_from_file_location("jax_demo_conic", ROOT / "demos" / "conic_return_mapping.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for name in ("rankine", "l1rankine", "vonmises_ps"):
        cls = {"rankine": "RankineExact", "l1rankine": "L1RankineExact", "vonmises_ps": "PlaneStressVonMisesExact"}[
            name]
        args = (E, nu, ft, fc) if name != "vonmises_ps" else (E, nu, 5.0)
        got = conic_return_mapping.stress_paths(getattr(tmodels, cls)(*args), n_dirs=4, device="cpu")
        want = mod.stress_paths(getattr(jmodels, cls)(*args), n_dirs=4)
        close(got, want, 1e-10, max(ft, fc))
