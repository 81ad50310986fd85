"""The port's Meric-Cailletaud crystal plasticity (``models/crystal.py``)
against the JAX package's, in float64 on the CPU, on strains made from a
numpy seed:

- slip systems, Schmid tensors, interaction matrix and cubic stiffness,
  bitwise equal;
- the whole-batch update over 3 committed steps at n = 24 against the JAX
  ``batched_update`` (stress and state to 1e-9 of scale, tangent to 1e-8,
  the same Newton count) and against the port's own per-point generic path
  (tests/test_crystal_batched.py's bars: stress 2e-7, tangent 1e-6, state
  1e-9);
- the flux-only update, the opt-out, and the per-point path against the JAX
  per-point path (1e-9);
- ``HenckyFiniteStrain(crystal)`` against the JAX composition
  (tests/test_gmsh_and_crystal_fs.py's case): PK1, tangent and p to 1e-9.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import dolfinx_materials_tpu as jdm  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.models import crystal as jcrystal  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.models import crystal as tcrystal  # noqa: E402

torch.set_num_threads(1)
KEYS = ("eps_p", "g", "p", "a")


def rand_eps(rng, n, amp):
    e = amp * rng.standard_normal((n, 6))
    e[: n // 4] = 0.0
    return e


def close(a, b, tol):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * (1.0 + np.abs(b).max()))


def test_geometry_bitwise():
    nt, dt_ = tcrystal.fcc_slip_systems()
    nj, dj = jcrystal.fcc_slip_systems()
    np.testing.assert_array_equal(nt, nj)
    np.testing.assert_array_equal(dt_, dj)
    np.testing.assert_array_equal(tcrystal.schmid_tensors_mandel(nt, dt_), jcrystal.schmid_tensors_mandel(nj, dj))
    np.testing.assert_array_equal(tmodels.fcc_interaction_matrix(), jmodels.fcc_interaction_matrix())
    np.testing.assert_array_equal(tmodels.cubic_elasticity_C(208e3, 0.3, 80e3),
                                  jmodels.cubic_elasticity_C(208e3, 0.3, 80e3))
    bt = tmodels.MericCailletaudCrystalPlasticity()
    bj = jmodels.MericCailletaudCrystalPlasticity()
    np.testing.assert_array_equal(bt.C6, np.asarray(bj.C6))
    np.testing.assert_array_equal(bt.mus, np.asarray(bj.mus))
    np.testing.assert_array_equal(bt.H, np.asarray(bj.H))


def test_batched_update_matches_jax_and_generic():
    n, dt = 24, 1e-2
    rng = np.random.default_rng(0)
    mat = tdm.Material(tmodels.MericCailletaudCrystalPlasticity(), device="cpu")
    mat.set_data_manager(n)
    fast = mat._fast_update
    mat._fast_update = None  # integrate() takes the generic path
    bj = jmodels.MericCailletaudCrystalPlasticity()
    sj = {k: jnp.asarray(np.asarray(v)) for k, v in mat.data_manager.s0.internal.items()}
    eps = rand_eps(rng, n, 2e-3)
    for _ in range(3):
        flux_g, _, Ct_g = mat.integrate(eps, dt=dt)
        sig_f, Ct_f, st_f = fast(torch.tensor(eps), mat.data_manager.s0.internal, dt)
        its = mat.behavior.last_newton_iters
        sig_j, Ct_j, sj_new = bj.batched_update(jnp.asarray(eps), sj, dt)
        close(sig_f, sig_j, 1e-9)
        close(Ct_f, Ct_j, 1e-8)
        for k in KEYS:
            close(st_f[k], sj_new[k], 1e-9)
        # the port's fast path against its own generic path
        np.testing.assert_allclose(sig_f, flux_g, atol=2e-7 * (float(flux_g.abs().max()) + 1.0))
        np.testing.assert_allclose(Ct_f, Ct_g, atol=1e-6 * float(Ct_g.abs().max()))
        s1 = mat.data_manager.s1.internal
        for k in KEYS:
            np.testing.assert_allclose(st_f[k], s1[k], atol=1e-9 * (1.0 + float(s1[k].abs().max())))
        # the JAX loop's iteration count, read back from its while_loop
        assert its == jax_newton_iters(bj, eps, sj, dt)
        mat.data_manager.update()
        sj = sj_new
        eps = eps + rand_eps(rng, n, 1e-3)
    assert float(mat.data_manager.s0["p"].max()) > 1e-4


def jax_newton_iters(bj, eps, state, dt):
    """The JAX whole-batch Newton's iteration count: its loop, run again
    with the counter as the returned value."""
    counted = []
    orig = jax.lax.while_loop

    def while_loop(cond, body, init):
        out = orig(cond, body, init)
        counted.append(int(out[1]))
        return out

    jax.lax.while_loop = while_loop
    try:
        bj.batched_flux(jnp.asarray(eps), state, dt)
    finally:
        jax.lax.while_loop = orig
    return counted[0]


def test_flux_only_and_opt_out():
    n, dt = 8, 1e-2
    rng = np.random.default_rng(1)
    mat = tdm.Material(tmodels.MericCailletaudCrystalPlasticity(), device="cpu")
    mat.set_data_manager(n)
    assert mat._fast_flux is not None
    eps = rand_eps(rng, n, 2e-3)
    flux_full, _, _ = mat.integrate(eps, dt=dt)
    flux_only, _ = mat.integrate_flux_only(eps, dt=dt)
    np.testing.assert_allclose(flux_only, flux_full, rtol=1e-10, atol=1e-10)
    off = tdm.Material(tmodels.MericCailletaudCrystalPlasticity(use_batched_fast=False), device="cpu")
    assert off._fast_update is None and off._fast_flux is None
    # the per-point path against the JAX per-point path
    mj = jdm.Material(jmodels.MericCailletaudCrystalPlasticity(use_batched_fast=False))
    st, _, Ct = off.integrate(eps, dt=dt)
    sj, _, Cj = mj.integrate(jnp.asarray(eps), dt=dt)
    close(st, sj, 1e-9)
    close(Ct, Cj, 1e-9)
    for k in KEYS:
        close(off.data_manager.s1[k], mj.data_manager.s1[k], 1e-9)


def test_hencky_crystal_matches_jax():
    n, gam = 4, 4e-3
    F = np.tile([1.0, 1, 1, 0, 0, 0, 0, 0, 0], (n, 1))
    F[:, 3] = gam
    F[1:, 4] = 1e-3 * np.arange(1, n)  # distinct points
    mt = tdm.Material(tmodels.HenckyFiniteStrain(tmodels.MericCailletaudCrystalPlasticity()), device="cpu")
    mj = jdm.Material(jmodels.HenckyFiniteStrain(jmodels.MericCailletaudCrystalPlasticity()))
    Pt, _, Ct = mt.integrate(F, dt=0.1)
    Pj, _, Cj = mj.integrate(jnp.asarray(F), dt=0.1)
    close(Pt, Pj, 1e-9)
    close(Ct, Cj, 1e-9)
    close(mt.data_manager.s1["p"], mj.data_manager.s1["p"], 1e-9)
    assert float(mt.data_manager.s1["p"].max()) > 1e-6
