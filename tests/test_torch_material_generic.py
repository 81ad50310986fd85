"""The port's generic constitutive path (``Material`` with ``vmap(jacfwd)``
over per-point updates whose roots carry implicit-function-theorem
derivatives) against the JAX package, in float64 on the CPU.

Same numpy inputs and the same prior state (carried across with
``state.from_reference_state``) through ``Material.batched_constitutive_update``
of both packages, for every small-strain behavior family. Tolerances, as
tests/test_j2_fast.py sets them for this path: stress 1e-8 of its scale,
tangent 1e-7 E, state 1e-10 (both sides stop their local Newton at 1e-10 or
tighter and evaluate the same closed forms at the root).
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.models.base import SmallStrainBehavior as JSmallStrain  # noqa: E402
from dolfinx_materials_tpu.ops import tensors as jtensors  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.models.base import SmallStrainBehavior as TSmallStrain  # noqa: E402
from dolfinx_materials_tpu_torch.ops import tensors as ttensors  # noqa: E402
from dolfinx_materials_tpu_torch.state import from_reference_array, from_reference_state  # noqa: E402

torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0
N = 48


def tmat(behavior):
    return tdm.Material(behavior, device="cpu")


def strains(n, seed, plane=False):
    """Mixed elastic/inelastic batch: scales straddle the yield strain."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(n, 6)) * np.geomspace(1e-4, 3e-2, n)[:, None]
    if plane:
        eps[:, [2, 4, 5]] = 0.0
    return eps


def plastic_state(n, seed):
    rng = np.random.default_rng(seed)
    ep = 1e-3 * rng.normal(size=(n, 6))
    ep[:, :3] -= ep[:, :3].mean(axis=1, keepdims=True)
    return {"eps_p": ep, "p": 1e-3 * np.abs(rng.normal(size=n))}


# ------------------------------------------------------- twin of test_j2_fast
def _compare_fast_generic(hardening, seed, prior_state=False):
    el = tmodels.LinearElasticIsotropic(E, NU)
    mat = tmat(tmodels.vonMisesIsotropicHardening(el, hardening))
    assert mat._fast_update is not None, "fast path must be wired in"
    n = 64
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(n, 6)) * np.geomspace(1e-4, 5e-2, n)[:, None]
    mat.set_data_manager(n)
    if prior_state:
        ep0 = rng.normal(size=(n, 6)) * 1e-3
        ep0[:, :3] -= ep0[:, :3].mean(axis=1, keepdims=True)
        mat.data_manager.s0["eps_p"] = ep0
        mat.data_manager.s0["p"] = np.abs(rng.normal(size=n)) * 1e-3
    state0 = mat.data_manager.s0.internal
    eps = torch.as_tensor(eps)
    sig_f, _, Ct_f = mat.integrate(eps)  # fast path (what integrate uses)
    sig_g, Ct_g, new_g = mat.batched_constitutive_update(eps, {}, state0, 0.0)  # generic IFT path
    scale = float(sig_g.abs().max())
    assert float(new_g["p"].max()) > 1e-3, "must exercise the plastic branch"
    np.testing.assert_allclose(sig_f.numpy(), sig_g.numpy(), rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(Ct_f.numpy(), Ct_g.reshape(n, -1).numpy(), rtol=0, atol=1e-7 * E)
    np.testing.assert_allclose(mat.data_manager.s1["p"].numpy().ravel(), new_g["p"].numpy(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(mat.data_manager.s1["eps_p"].numpy(), new_g["eps_p"].numpy(), rtol=0, atol=1e-12)


def test_fast_matches_generic_linear():
    _compare_fast_generic(tmodels.LinearHardening(SIG0, 1000.0), 0)


def test_fast_matches_generic_voce():
    _compare_fast_generic(tmodels.VoceHardening(SIG0, 500.0, 1e3), 1)


def test_fast_matches_generic_with_prior_state():
    _compare_fast_generic(tmodels.VoceHardening(SIG0, 500.0, 1e3), 2, prior_state=True)


def test_fast_perfect_plasticity():
    _compare_fast_generic(tmodels.LinearHardening(SIG0, 0.0), 3)


def test_elastic_branch_exact_tangent():
    """Below yield the root is exactly 0, so the tangent is exactly C (the bar
    of tests/test_plasticity.py::test_elastic_branch_exact_tangent)."""
    el = tmodels.LinearElasticIsotropic(E, NU)
    mat = tmat(tmodels.vonMisesIsotropicHardening(el, tmodels.VoceHardening(SIG0, 500.0, 1e3)))
    eps = torch.as_tensor(strains(8, 4) * 1e-3)
    mat.set_data_manager(8)
    sig, Ct, st = mat.batched_constitutive_update(eps, {}, mat.data_manager.s0.internal, 0.0)
    assert float(st["p"].abs().max()) == 0.0
    np.testing.assert_allclose(Ct.reshape(8, 6, 6).numpy(), np.broadcast_to(el.C, (8, 6, 6)), rtol=1e-14, atol=0)


# ------------------------------------------- every behavior family against JAX
C1 = np.asarray(jtensors.isotropic_C(E, NU))
H_GSM, ETA_GSM = 0.3 * C1, 50.0


def gsm(models, xp):
    C, H = xp.asarray(C1), xp.asarray(H_GSM)

    def psi(eps, a):
        d = eps - a
        return 0.5 * d @ C @ d + 0.5 * a @ H @ a + 1e3 * xp.sum(a**4)

    def phi(adot):
        return 0.5 * ETA_GSM * adot @ adot

    return models.GeneralizedStandardMaterial(psi, phi, n_internal=6)


def j2(models, law="VoceHardening", args=(SIG0, 500.0, 1e3)):
    return models.LinearElasticIsotropic(E, NU), getattr(models, law)(*args)


#: name -> (make(models, xp), prior state maker or None, dt, plane strains)
CASES = {
    "elastic_isotropic": (lambda m, xp: m.LinearElasticIsotropic(E, NU), None, 0.0, False),
    "elastic_orthotropic": (
        lambda m, xp: m.LinearElasticOrthotropic(100e3, 10e3, 10e3, 0.3, 0.3, 0.3, 5e3, 5e3, 4e3),
        None, 0.0, False),
    "von_mises_voce": (lambda m, xp: m.vonMisesIsotropicHardening(*j2(m)), plastic_state, 0.0, False),
    "von_mises_swift": (
        lambda m, xp: m.vonMisesIsotropicHardening(*j2(m, "SwiftHardening", (SIG0, 2e-3, 0.2))),
        plastic_state, 0.0, False),
    "von_mises_ramberg_osgood": (
        lambda m, xp: m.vonMisesIsotropicHardening(*j2(m, "RambergOsgoodHardening", (SIG0, E, 2e-3, 5.0))),
        plastic_state, 0.0, False),
    "general_von_mises": (lambda m, xp: m.GeneralIsotropicHardening(*j2(m)), plastic_state, 0.0, False),
    "general_hosford": (
        lambda m, xp: m.GeneralIsotropicHardening(
            *j2(m, "LinearHardening", (SIG0, 2e3)), stress_norm=m.hosford_norm(6.0, 1e-10)),
        plastic_state, 0.0, False),
    "hosford": (lambda m, xp: m.HosfordPlasticity(*j2(m, "LinearHardening", (SIG0, 2e3)), a=8.0),
                None, 0.0, False),
    "rankine": (lambda m, xp: m.RankinePlasticity(*j2(m, "LinearHardening", (SIG0, 2e3)), smooth=1e-2),
                None, 0.0, False),
    "l1_rankine": (lambda m, xp: m.L1RankinePlasticity(*j2(m, "LinearHardening", (SIG0, 2e3)), smooth=1e-2),
                   None, 0.0, False),
    "norton": (
        lambda m, xp: m.NortonViscoplasticity(
            m.LinearElasticIsotropic(E, NU), m.LinearHardening(100.0, 1e3), K=150.0, n=3.0),
        plastic_state, 0.1, False),
    "gsm": (gsm, lambda n, seed: {"alpha": 1e-4 * np.random.default_rng(seed).normal(size=(n, 6))}, 0.1, False),
    "generalized_maxwell": (
        lambda m, xp: m.GeneralizedMaxwell(50e3, 10e3, [(20e3, 0.5), (8e3, 5.0), (3e3, 50.0)]),
        lambda n, seed: {"epsv": 1e-3 * np.random.default_rng(seed).normal(size=(n, 18))}, 0.3, False),
    "zener": (lambda m, xp: m.ZenerViscoelasticity(50e3, 10e3, 20e3, 0.5),
              lambda n, seed: {"epsv": 1e-3 * np.random.default_rng(seed).normal(size=(n, 6))}, 0.2, False),
    "ramberg_osgood_elasticity": (
        lambda m, xp: m.RambergOsgoodNonLinearElasticity(E, NU, SIG0, 2e-3, 5.0), None, 0.0, False),
    "plane_stress_elastic": (lambda m, xp: m.PlaneStress(m.LinearElasticIsotropic(E, NU)), None, 0.0, True),
    "plane_stress_j2": (
        lambda m, xp: m.PlaneStress(m.vonMisesIsotropicHardening(*j2(m, "LinearHardening", (SIG0, 1e3)))),
        lambda n, seed: {**plastic_state(n, seed), "eps_zz": 1e-4 * np.random.default_rng(seed).normal(size=n)},
        0.0, True),
    "plane_stress_norton": (
        lambda m, xp: m.PlaneStress(m.NortonViscoplasticity(
            m.LinearElasticIsotropic(E, NU), m.LinearHardening(100.0, 1e3), K=150.0, n=3.0)),
        None, 0.1, True),
}


def run_both(name, n=N, seed=11):
    make, prior, dt, plane = CASES[name]
    eps = strains(n, seed, plane)
    jmat = jdm.Material(make(jmodels, jnp))
    jmat.set_data_manager(n)
    mat = tmat(make(tmodels, torch))
    mat.set_data_manager(n)
    if prior is not None:
        for k, v in prior(n, seed + 1).items():
            jmat.data_manager.s0[k] = v
        # the JAX package's state dict is what crosses over
        mat.set_initial_state_dict(
            {k: v for k, v in from_reference_state(jmat.get_initial_state_dict(), device="cpu").items()
             if k in mat.internal_state_variables}
        )
    want = jmat.batched_constitutive_update(jnp.asarray(eps), {}, jmat.data_manager.s0.internal, dt)
    got = mat.batched_constitutive_update(torch.as_tensor(eps), {}, mat.data_manager.s0.internal, dt)
    return got, want, mat, jmat


@pytest.mark.parametrize("name", sorted(CASES))
def test_generic_update_matches_jax(name):
    (sig, Ct, st), (sig_j, Ct_j, st_j), mat, _ = run_both(name)
    sig_j, Ct_j = np.asarray(sig_j), np.asarray(Ct_j)
    assert sig.shape == sig_j.shape and Ct.shape == Ct_j.shape
    assert np.isfinite(sig.numpy()).all() and np.isfinite(Ct.numpy()).all()
    scale = float(np.abs(sig_j).max())
    assert float(np.abs(sig.numpy() - sig_j).max()) <= 1e-8 * scale
    assert float(np.abs(Ct.numpy() - Ct_j).max()) <= 1e-7 * E
    assert set(st) == set(st_j)
    for k in st:
        want = np.asarray(st_j[k])
        assert st[k].shape == want.shape
        assert float(np.abs(st[k].numpy() - want).max()) <= 1e-10, k
    if "p" in st:
        dp = st["p"].numpy() - mat.data_manager.s0["p"].numpy().ravel()
        assert (dp > 1e-5).any() and (dp < 1e-14).any(), "batch must mix elastic and inelastic points"


def test_general_matches_radial_return():
    """GeneralIsotropicHardening with its default von Mises norm is the radial
    return (tests/test_plasticity.py::test_general_matches_radial_return)."""
    (sig_g, Ct_g, st_g), _, _, _ = run_both("general_von_mises")
    (sig_v, Ct_v, st_v), _, _, _ = run_both("von_mises_voce")
    scale = float(sig_v.abs().max())
    assert float((sig_g - sig_v).abs().max()) <= 1e-8 * scale
    assert float((Ct_g - Ct_v).abs().max()) <= 1e-6 * E
    assert float((st_g["p"] - st_v["p"]).abs().max()) <= 1e-10


def test_array_valued_state_crosses_over_with_its_shape():
    _, _, mat, jmat = run_both("generalized_maxwell")
    assert tuple(mat.data_manager.s0.internal["epsv"].shape) == (N, 3, 6)
    np.testing.assert_array_equal(mat.data_manager.s0["epsv"].numpy(), np.asarray(jmat.data_manager.s0["epsv"]))


# ------------------------------------------------------- integrate entry points
@pytest.mark.parametrize("name", ["norton", "generalized_maxwell", "plane_stress_j2", "general_von_mises"])
def test_integrate_matches_jax_and_flux_only_matches_integrate(name):
    make, prior, dt, plane = CASES[name]
    eps = strains(16, 5, plane)
    jmat = jdm.Material(make(jmodels, jnp))
    f_j, isv_j, Ct_j = jmat.integrate(jnp.asarray(eps), dt)
    mat, mat2 = tmat(make(tmodels, torch)), tmat(make(tmodels, torch))
    f, isv, Ct = mat.integrate(eps, dt)  # numpy in: the entry point converts
    f2, isv2 = mat2.integrate_flux_only(torch.as_tensor(eps), dt)
    scale = float(np.abs(np.asarray(f_j)).max())
    assert float(np.abs(f.numpy() - np.asarray(f_j)).max()) <= 1e-8 * scale
    assert float(np.abs(Ct.numpy() - np.asarray(Ct_j)).max()) <= 1e-7 * E
    assert float(np.abs(isv.numpy() - np.asarray(isv_j)).max()) <= 1e-10
    # the tangent-free path evaluates the same update: equal to rounding
    np.testing.assert_allclose(f2.numpy(), f.numpy(), rtol=1e-12, atol=1e-12 * scale)
    np.testing.assert_allclose(isv2.numpy(), isv.numpy(), rtol=1e-12, atol=1e-15)
    # both store the trial state in s1 and leave s0 alone
    np.testing.assert_array_equal(mat.data_manager.s1.internal_state_variables.numpy(), isv.numpy())
    assert float(mat.data_manager.s0.internal_state_variables.abs().max()) == 0.0


F32_CASES = {
    "von_mises": lambda m: m.vonMisesIsotropicHardening(*j2(m), tol=1e-5),
    "general_von_mises": lambda m: m.GeneralIsotropicHardening(*j2(m), tol=1e-5),
    "norton": lambda m: m.NortonViscoplasticity(
        m.LinearElasticIsotropic(E, NU), m.LinearHardening(100.0, 1e3), K=150.0, n=3.0, tol=1e-6),
    "plane_stress_j2": lambda m: m.PlaneStress(
        m.vonMisesIsotropicHardening(*j2(m, "LinearHardening", (SIG0, 1e3)), tol=1e-5), tol=1e-3),
}


@pytest.mark.parametrize("name", sorted(F32_CASES))
def test_generic_path_keeps_float32(name):
    """In float32 the generic path returns float32 (forward-mode derivatives
    of 0-d intermediates come back from torch.func as float64 and are cast)
    and agrees with its own float64 run to f32 rounding through the local
    Newton: stress 1e-4 of scale, tangent 1e-2 E (local tolerances loosened
    to what f32 can reach)."""
    eps = strains(24, 6, plane=name.startswith("plane"))
    out = {}
    for dtype in (torch.float32, torch.float64):
        mat = tdm.Material(F32_CASES[name](tmodels), device="cpu", dtype=dtype)
        out[dtype] = mat.integrate(eps, 0.1)
        assert all(t.dtype == dtype for t in out[dtype])
    (f32, _, C32), (f64, _, C64) = out[torch.float32], out[torch.float64]
    assert bool(torch.isfinite(C32).all())
    assert float((f32.double() - f64).abs().max()) <= 1e-4 * float(f64.abs().max())
    assert float((C32.double() - C64).abs().max()) <= 1e-2 * E


def test_batched_flux_hook_is_used():
    """A behavior's tangent-free whole-batch companion serves integrate_flux_only."""
    calls = []

    class WithFlux(tmodels.vonMisesIsotropicHardening):
        def batched_flux(self, eps, state, dt):
            calls.append(eps.shape)
            sig, _, new = self.batched_update(eps, state, dt)
            return sig, new

    mat = tmat(WithFlux(*j2(tmodels)))
    eps = torch.as_tensor(strains(8, 2))
    f1, isv1 = mat.integrate_flux_only(eps)
    f2, isv2, _ = mat.integrate(eps)
    assert calls == [(8, 6)]
    torch.testing.assert_close(f1, f2, rtol=0, atol=0)
    torch.testing.assert_close(isv1, isv2, rtol=0, atol=0)


# ------------------------------------------------------------------- rotations
def rand_rot(seed):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(Q) < 0:
        Q[:, 0] *= -1
    return Q


ORTHO = (100e3, 10e3, 10e3, 0.3, 0.3, 0.3, 5e3, 5e3, 4e3)


def test_rotation_orthotropic_changes_response():
    """tests/test_misc.py::test_rotation_orthotropic_changes_response in the
    port, and the rotated response against JAX (1e-10 of scale)."""
    beh = tmodels.LinearElasticOrthotropic(*ORTHO)
    eps = np.zeros((1, 6))
    eps[0, 0] = 1e-3
    s0, _, _ = tmat(beh).integrate(eps)
    m90 = tmat(beh)
    m90.rotation_matrix = np.array([[0.0, 1.0, 0.0], [-1.0, 0.0, 0.0], [0.0, 0.0, 1.0]])
    s90, _, _ = m90.integrate(eps)
    assert not np.allclose(s90.numpy(), s0.numpy())
    eps_yy = np.zeros((1, 6))
    eps_yy[0, 1] = 1e-3
    s_mat, _, _ = tmat(beh).integrate(eps_yy)
    np.testing.assert_allclose(float(s90[0, 0]), float(s_mat[0, 1]), rtol=1e-10)


@pytest.mark.parametrize("per_point", [False, True])
def test_rotated_orthotropic_matches_jax(per_point):
    n = 6
    eps = strains(n, 8) * 0.1
    R = np.stack([rand_rot(s) for s in range(n)]) if per_point else rand_rot(1)
    jmat = jdm.Material(jmodels.LinearElasticOrthotropic(*ORTHO))
    jmat.rotation_matrix = jnp.asarray(R)
    s_j, _, C_j = jmat.integrate(jnp.asarray(eps))
    mat = tmat(tmodels.LinearElasticOrthotropic(*ORTHO))
    mat.rotation_matrix = from_reference_array(R, device="cpu")
    s, _, C = mat.integrate(eps)
    assert float(np.abs(s.numpy() - np.asarray(s_j)).max()) <= 1e-10 * float(np.abs(np.asarray(s_j)).max())
    assert float(np.abs(C.numpy() - np.asarray(C_j)).max()) <= 1e-10 * 100e3
    f, _ = mat.integrate_flux_only(eps)
    np.testing.assert_allclose(f.numpy(), s.numpy(), rtol=1e-13, atol=0)


def test_rotation_isotropic_objectivity_small_strain():
    """For an isotropic behavior the material-frame rotation must not change
    the response: exercises the Mandel-6 operator on inputs, fluxes and the
    tangent, through the generic path with a plastic state (1e-9, as the
    finite-strain twin of this test in tests/test_misc.py)."""
    n = 12
    eps = strains(n, 9)

    def make():
        return tmat(tmodels.GeneralIsotropicHardening(*j2(tmodels)))

    s0, isv0, C0 = make().integrate(eps)
    m_rot = make()
    m_rot.rotation_matrix = rand_rot(1)
    s1, isv1, C1r = m_rot.integrate(eps)
    assert float(isv0[:, 6].max()) > 1e-4, "must exercise the plastic branch"
    scale = float(s0.abs().max())
    np.testing.assert_allclose(s1.numpy(), s0.numpy(), rtol=0, atol=1e-9 * scale)
    np.testing.assert_allclose(C1r.numpy(), C0.numpy(), rtol=0, atol=1e-8 * E)
    np.testing.assert_allclose(isv1[:, 6].numpy(), isv0[:, 6].numpy(), rtol=0, atol=1e-12)  # p is a scalar


# ------------------------------------------------------------ property updates
def test_update_material_property_rebuild():
    mat = tmat(tmodels.LinearElasticIsotropic(70e3, 0.3))
    eps = np.zeros((2, 6))
    eps[:, 0] = 1e-3
    s1, _, _ = mat.integrate(eps)
    mat.update_material_property("E", 140e3)
    s2, _, _ = mat.integrate(eps)
    np.testing.assert_allclose(s2.numpy(), 2 * s1.numpy(), rtol=1e-12)


def test_update_material_property_invalidates_fast_path():
    """tests/test_misc.py:97-123: a cached whole-batch update must not keep
    serving the parameters from before update_material_property."""
    mat = tmat(tmodels.vonMisesIsotropicHardening(
        tmodels.LinearElasticIsotropic(70e3, 0.3), tmodels.LinearHardening(350.0, 100.0)))
    mat.set_data_manager(2)
    eps = np.zeros((2, 6))
    eps[:, 0] = 3 * 350.0 / 70e3  # well plastic
    s_old, _, _ = mat.integrate(eps)
    assert mat._fast_update is not None and "_fast" in mat.behavior.__dict__
    mat.update_material_property("yield_stress", tmodels.LinearHardening(700.0, 100.0))
    assert "_fast" not in mat.behavior.__dict__
    mat.data_manager.s0["eps_p"] = np.zeros((2, 6))
    mat.data_manager.s0["p"] = np.zeros((2, 1))
    s_new, _, _ = mat.integrate(eps)
    assert not np.allclose(s_new.numpy(), s_old.numpy())
    assert float(s_new[0, 0]) > float(s_old[0, 0]) * 1.2
    # and the result is the JAX package's after the same update
    jmat = jdm.Material(jmodels.vonMisesIsotropicHardening(
        jmodels.LinearElasticIsotropic(70e3, 0.3), jmodels.LinearHardening(350.0, 100.0)))
    jmat.set_data_manager(2)
    jmat.integrate(jnp.asarray(eps))
    jmat.update_material_property("yield_stress", jmodels.LinearHardening(700.0, 100.0))
    s_j, _, _ = jmat.integrate(jnp.asarray(eps))
    np.testing.assert_allclose(s_new.numpy(), np.asarray(s_j), rtol=1e-10)


# --------------------------------- spatially varying properties and ESVs
def varying_elasticity(base, xp, tensors):
    class VaryingElasticity(base):
        """A spatially varying Young modulus as a declared material property
        (tests/test_initialization.py:76-93)."""

        material_properties = {"YoungModulus": 1}

        def constitutive_update(self, inputs, state, dt):
            Ey, eps = inputs["YoungModulus"], inputs["Strain"]
            lmbda = Ey * NU / (1 + NU) / (1 - 2 * NU)
            mu = Ey / 2 / (1 + NU)
            return {"Stress": lmbda * tensors.tr(eps) * xp.asarray(tensors.I2) + 2 * mu * eps}, state

    return VaryingElasticity()


def test_spatially_varying_material_property():
    n = 16
    eps = np.zeros((n, 6))
    eps[:, 0] = 1e-3
    mat = tmat(varying_elasticity(TSmallStrain, torch, ttensors))
    with pytest.raises(ValueError, match="has not been set"):
        mat.integrate(eps)
    mat.update_material_property("YoungModulus", E)  # scalar value
    sig1, _, _ = mat.integrate(eps)
    Evar = np.full(n, E)
    Evar[n // 2:] = 2 * E  # per-point array: doubled stiffness on the second half
    mat.update_material_property("YoungModulus", from_reference_array(Evar, device="cpu"))
    sig2, _, Ct2 = mat.integrate(eps)
    np.testing.assert_allclose(sig2.numpy()[: n // 2], sig1.numpy()[: n // 2])
    np.testing.assert_allclose(sig2.numpy()[n // 2:], 2 * sig1.numpy()[n // 2:], rtol=1e-12)
    jmat = jdm.Material(varying_elasticity(JSmallStrain, jnp, jtensors))
    jmat.update_material_property("YoungModulus", Evar)
    sig_j, _, Ct_j = jmat.integrate(jnp.asarray(eps))
    np.testing.assert_allclose(sig2.numpy(), np.asarray(sig_j), rtol=1e-13)
    np.testing.assert_allclose(Ct2.numpy(), np.asarray(Ct_j), rtol=1e-13, atol=1e-9)


def thermo_elastic(base, xp, tensors, stack):
    class ThermoElastic(base):
        """Isotropic thermo-elasticity with the temperature as an external
        state variable, a stored thermal strain, and the extra tangent blocks
        d(Stress)/dT and d(eps_th)/dT."""

        external_state_variables = {"Temperature": 1}
        extra_tangent_blocks = [("Stress", "Temperature"), ("eps_th", "Temperature")]

        def init_state(self):
            return {"eps_th": np.zeros(())}

        def constitutive_update(self, inputs, state, dt):
            eps, T = inputs["Strain"], inputs["Temperature"][0]
            eth = 1e-5 * (T - 293.0) + 1e-8 * (T - 293.0) ** 2
            e = eps - eth * xp.asarray(tensors.I2)
            lmbda = E * NU / (1 + NU) / (1 - 2 * NU)
            mu = E / 2 / (1 + NU)
            sig = lmbda * tensors.tr(e) * xp.asarray(tensors.I2) + 2 * mu * e
            return {"Stress": sig}, {"eps_th": eth}

    return ThermoElastic()


def test_external_state_variable_and_extra_tangent_blocks():
    n = 10
    eps = strains(n, 3) * 0.1
    T = 293.0 + 50.0 * np.random.default_rng(4).random(n)
    mat = tmat(thermo_elastic(TSmallStrain, torch, ttensors, torch.stack))
    jmat = jdm.Material(thermo_elastic(JSmallStrain, jnp, jtensors, jnp.stack))
    assert mat.tangent_blocks == jmat.tangent_blocks == {
        ("Stress", "Strain"): (6, 6), ("Stress", "Temperature"): (6, 1), ("eps_th", "Temperature"): (1, 1)}
    with pytest.raises(KeyError, match="does not declare ESV"):
        mat.update_external_state_variable("Pressure", 1.0)
    # unset ESV reads as zero, a scalar broadcasts, an array is per point
    for value in (None, 300.0, T):
        if value is not None:
            mat.update_external_state_variable("Temperature", value if np.ndim(value) == 0 else from_reference_array(value, device="cpu"))
            jmat.update_external_state_variable("Temperature", value)
        s, isv, Ct = mat.integrate(eps)
        s_j, isv_j, Ct_j = jmat.integrate(jnp.asarray(eps))
        assert Ct.shape == (n, 36 + 6 + 1)
        np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=1e-12, atol=1e-12 * float(np.abs(np.asarray(s_j)).max()))
        np.testing.assert_allclose(Ct.numpy(), np.asarray(Ct_j), rtol=1e-12, atol=1e-10)
        np.testing.assert_allclose(isv.numpy(), np.asarray(isv_j), rtol=1e-12, atol=1e-18)
