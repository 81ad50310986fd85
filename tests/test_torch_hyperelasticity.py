"""The port's hyperelastic behaviors (``models/hyperelasticity.py``) and the
finite-strain path of its ``Material`` against the JAX package's, in float64
on the CPU, on deformation gradients made from a numpy seed. PK1 and the
81-wide tangent are held to 1e-12 of their largest entry (the tolerance of
tests/test_ogden_c6_tangent.py); the Ogden PK2 is also held against the
MFront formula to 1e-9, as tests/test_ogden_mfront_parity.py does. At the
state with two coincident stretches the whole-batch Ogden tangent is held
to the Hessian of the JAX package's per-point energy (``logm``/``expm``, no
eigenvalues) instead: there the JAX package's whole-batch path, whose
clamped Cardano eigenvalues lose the energy's Hessian, is 3 % of the
tangent's scale off, and the port's coincident-pair series is not."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import dolfinx_materials_tpu as jdm  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.ops import tensors as jtensors  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402

torch.set_num_threads(1)

ALPHA, MU_MF, K_MF = 28.8, 27778.0, 69444444.0
I9 = np.array([1.0, 1, 1, 0, 0, 0, 0, 0, 0])


def deformations(n=24, amp=0.15, seed=0):
    """Random F near I, plus F = I, a pure dilatation and a rotation of a
    state with two coincident stretches."""
    rng = np.random.default_rng(seed)
    F = I9 + amp * rng.standard_normal((n, 9))
    Q, _ = np.linalg.qr(rng.standard_normal((3, 3)))
    Q *= np.sign(np.linalg.det(Q))
    pair = Q @ np.diag([1.1, 1.1, 0.85])
    pair9 = pair.reshape(9)[[0, 4, 8, 1, 3, 2, 6, 5, 7]]
    return np.concatenate([F, I9[None], 1.05 * I9[None], pair9[None]])


def close(a, b, rtol=1e-12):
    a, b = np.asarray(a), np.asarray(b)
    assert np.isfinite(a).all()
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * np.abs(b).max())


def close_ogden_tangent(model, Fv, Ct, Cj):
    """An Ogden tangent against the JAX package's whole-batch one on every
    row of :func:`deformations` but the last, the coincident pair, which is
    held to the Hessian of the JAX package's per-point energy (the same
    9-vector order)."""
    Ct = np.asarray(Ct)
    close(Ct[:-1], np.asarray(Cj)[:-1])
    per_point = jmodels.Ogden(mu=model.mu, alpha=model.alpha, K=model.K)
    H = jax.hessian(lambda v: per_point.strain_energy(jtensors.nonsym_to_mat(v)))(jnp.asarray(Fv[-1]))
    close(Ct[-1:], np.asarray(H).reshape(1, 81))


def ogden(pkg, **kw):
    return pkg.Ogden(mu=(MU_MF * ALPHA / 2.0,), alpha=(ALPHA,), K=K_MF, **kw)


BATCHED = {
    "ogden_c6": lambda m: ogden(m, tangent_mode="c6"),
    "ogden_f9": lambda m: ogden(m, tangent_mode="f9"),
    "ogden_two_terms": lambda m: m.Ogden(mu=(4e5, -2e4), alpha=(28.8, -3.0), K=1e8),
}


@pytest.mark.parametrize("name", sorted(BATCHED))
def test_batched_update_matches_jax(name):
    Fv = deformations()
    model = BATCHED[name](tmodels)
    pt, Ct, _ = model.batched_update(torch.tensor(Fv), {}, 0.0)
    pj, Cj, _ = BATCHED[name](jmodels).batched_update(jnp.asarray(Fv), {}, 0.0)
    assert tuple(Ct.shape) == (Fv.shape[0], 81)
    close(pt, pj)
    close_ogden_tangent(model, Fv, Ct, Cj)


def test_c6_matches_f9_and_chunked_matches_one_chunk():
    Fv = torch.tensor(deformations(seed=1))
    p6, C6, _ = ogden(tmodels).batched_update(Fv, {}, 0.0)
    p9, C9, _ = ogden(tmodels, tangent_mode="f9").batched_update(Fv, {}, 0.0)
    close(p6, p9)
    close(C6, C9)
    for mode in ("c6", "f9"):
        pc, Cc, _ = ogden(tmodels, tangent_mode=mode, tangent_chunk=5).batched_update(Fv, {}, 0.0)
        p1, C1, _ = ogden(tmodels, tangent_mode=mode).batched_update(Fv, {}, 0.0)
        close(pc, p1)
        close(Cc, C1)


def test_batched_energy_and_per_point_energy_match_jax():
    Fv = deformations(seed=2)
    close(ogden(tmodels).strain_energy_batched(torch.tensor(Fv)),
          ogden(jmodels).strain_energy_batched(jnp.asarray(Fv)), 1e-12)
    F = Fv[:4].reshape(4, 9)[:, [0, 3, 5, 4, 1, 7, 6, 8, 2]].reshape(4, 3, 3)
    for k in range(4):
        close(ogden(tmodels).strain_energy(torch.tensor(F[k])), ogden(jmodels).strain_energy(jnp.asarray(F[k])),
              1e-10)


def S_mfront(F):
    """PK2 stress of the MFront Ogden integrator (tests/test_ogden_mfront_parity.py)."""
    a = ALPHA / 2
    C = F.T @ F
    J = np.linalg.det(F)
    C2 = C @ C
    I1 = np.trace(C)
    I2 = (I1 * I1 - np.trace(C2)) / 2
    dI3_dC = C2 - I1 * C + I2 * np.eye(3)
    Sv = K_MF * (J - 1) / J * dI3_dC
    iJb = (J * J) ** (-1 / 3.0)
    vp, m = np.linalg.eigh(C)
    pwv = vp ** (a - 2)
    df_dC = m @ np.diag(a * vp * pwv) @ m.T
    Si = MU_MF * iJb ** (a - 2) * iJb * (np.sum(vp * vp * pwv) * (-(iJb**4) / 3) * dI3_dC + (iJb / a) * df_dC)
    return Sv + Si


def test_pk2_matches_the_mfront_formula():
    rng = np.random.default_rng(0)
    Fs = np.eye(3)[None] + 0.2 * rng.standard_normal((20, 3, 3))
    Fv = Fs.reshape(20, 9)[:, [0, 4, 8, 1, 3, 2, 6, 5, 7]]
    pk1, _, _ = ogden(tmodels).batched_update(torch.tensor(Fv), {}, 0.0)
    P = pk1.numpy()[:, [0, 3, 5, 4, 1, 7, 6, 8, 2]].reshape(20, 3, 3)
    for k in range(20):
        S_ref = S_mfront(Fs[k])
        assert np.abs(np.linalg.solve(Fs[k], P[k]) - S_ref).max() <= 1e-9 * np.abs(S_ref).max()


MATERIALS = {
    "ogden": lambda m: ogden(m),
    "neohooke": lambda m: m.NeoHooke(mu=3e5, K=2e7),
    "svk": lambda m: m.SaintVenantKirchhoff(2e5, 0.3),
    "svk_inclusion": lambda m: m.SaintVenantKirchhoff(1e12, 0.0),
}


@pytest.mark.parametrize("name", sorted(MATERIALS))
def test_material_integrate_matches_jax(name):
    """``Material.integrate`` on F (n, 9): Ogden through its batched update,
    NeoHooke and SVK through the generic vmap(jacfwd) of the energy's
    gradient; PK1 and the (n, 81) tangent against the JAX Material."""
    Fv = deformations(seed=3)
    mt = tdm.Material(MATERIALS[name](tmodels), device="cpu")
    mj = jdm.Material(MATERIALS[name](jmodels))
    assert (mt._fast_update is not None) == (name == "ogden")
    pt, _, Ct = mt.integrate(Fv)
    pj, _, Cj = mj.integrate(jnp.asarray(Fv))
    assert tuple(Ct.shape) == (Fv.shape[0], 81)
    close(pt, pj)
    if name == "ogden":
        close_ogden_tangent(mt.behavior, Fv, Ct, Cj)
    else:
        close(Ct, Cj)
    fo, _ = mt.integrate_flux_only(Fv)
    close(fo, pj)


def test_float32_tangent_at_the_identity_is_finite():
    """F = I and a coincident pair in float32: finite PK1 and tangent, close
    to the float64 ones."""
    Fv = deformations(n=4, seed=4)
    p32, C32, _ = ogden(tmodels).batched_update(torch.tensor(Fv, dtype=torch.float32), {}, 0.0)
    p64, C64, _ = ogden(tmodels).batched_update(torch.tensor(Fv), {}, 0.0)
    assert bool(torch.isfinite(p32).all()) and bool(torch.isfinite(C32).all())
    np.testing.assert_allclose(C32.double().numpy(), C64.numpy(), rtol=0, atol=1e-3 * float(C64.abs().max()))
