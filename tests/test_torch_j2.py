"""The port's J2 return map against the JAX package, in float64.

- the j2_fast contract (cold start, 12 iterations, regularizer 1e-14): the
  port's Material fast path against JAX ``make_j2_batched_update``, for every
  hardening law;
- the Pallas contract (warm start, 4 iterations, regularizer 1e-7): the
  kernel wrapper against ``make_j2_pallas_update`` in interpret mode.

Tolerance: 1e-10 of each field's scale (max |sigma| for stress, E for the
tangent, the field's own max for the state); the two sides differ only in
the order of floating-point operations.
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.ops import tensors as jtensors  # noqa: E402
from dolfinx_materials_tpu.ops.j2_fast import make_j2_batched_update as jax_j2_fast  # noqa: E402
from dolfinx_materials_tpu.ops.pallas_j2 import make_j2_pallas_update  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.ops import j2_cuda  # noqa: E402
from dolfinx_materials_tpu_torch.ops.j2_fast import make_j2_batched_update  # noqa: E402
from dolfinx_materials_tpu_torch.ops.law_program import LAW_PROGRAM  # noqa: E402

# one intra-op thread: the suite runs several pytest workers on one machine,
# and spinning thread pools in each of them starve one another
torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0
RTOL = 1e-10

LAWS = {
    "linear": ("LinearHardening", (SIG0, 2e3)),
    "voce": ("VoceHardening", (SIG0, 500.0, 1e3)),
    "swift": ("SwiftHardening", (SIG0, 2e-3, 0.2)),
    "ramberg_osgood": ("RambergOsgoodHardening", (SIG0, E, 2e-3, 5.0)),
}


def build(pkg, law):
    cls, args = LAWS[law]
    return pkg.LinearElasticIsotropic(E, NU), getattr(pkg, cls)(*args)


def inputs(n, seed=0):
    """Mixed elastic/plastic batch with a prior plastic state (numpy f64)."""
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(n, 6)) * np.geomspace(1e-4, 4e-2, n)[:, None]
    eps_p = 1e-3 * rng.normal(size=(n, 6))
    eps_p[:, :3] -= eps_p[:, :3].mean(axis=1, keepdims=True)
    p = 5e-3 * rng.random(n)
    return eps, eps_p, p


def assert_close(got, want, scale, what):
    err = np.max(np.abs(np.asarray(got) - np.asarray(want))) / scale
    assert err <= RTOL, f"{what}: relative error {err:.2e} > {RTOL:.0e}"


@pytest.mark.parametrize("law", sorted(LAWS))
def test_j2_fast_contract_matches_jax(law):
    eps, eps_p, p = inputs(512)
    sig_j, Ct_j, st_j = jax_j2_fast(*build(jmodels, law))(
        jnp.asarray(eps), {"eps_p": jnp.asarray(eps_p), "p": jnp.asarray(p)}, 0.0
    )
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    sig, Ct, st = make_j2_batched_update(*build(tmodels, law))(
        t(eps), {"eps_p": t(eps_p), "p": t(p)}, 0.0
    )
    assert Ct.shape == (512, 36) and sig.shape == (512, 6)
    assert float(st["p"].max() - t(p).max()) > 1e-3, "must exercise the plastic branch"
    assert_close(sig, sig_j, np.abs(sig_j).max(), "stress")
    assert_close(Ct, Ct_j, E, "tangent")
    assert_close(st["eps_p"], st_j["eps_p"], np.abs(st_j["eps_p"]).max(), "eps_p")
    assert_close(st["p"], st_j["p"], np.abs(st_j["p"]).max(), "p")


@pytest.mark.parametrize("law", ["linear", "voce", "swift"])
def test_pallas_contract_matches_interpret_kernel(law):
    n = 512
    eps, eps_p, p = inputs(n, seed=1)
    fm = (eps.T.copy(), eps_p.T.copy(), p[None, :].copy())
    jk = make_j2_pallas_update(*build(jmodels, law), tile=128, interpret=True)
    want = jk(*(jnp.asarray(a) for a in fm))
    got = j2_cuda.j2_radial_return(
        *(torch.as_tensor(a) for a in fm), *build(tmodels, law), **j2_cuda.PALLAS_CONTRACT
    )
    assert got[1].shape == (36, n)
    assert float((got[3] - torch.as_tensor(p)).max()) > 1e-3, "must exercise the plastic branch"
    for g, w, name in zip(got, want, ("stress", "tangent", "eps_p", "p")):
        scale = E if name == "tangent" else np.abs(np.asarray(w)).max()
        assert_close(g, w, scale, name)


def test_layouts_agree():
    """Point-major and feature-major calls of the wrapper give the same
    numbers, and the layout helpers invert each other."""
    el, law = build(tmodels, "voce")
    eps, eps_p, p = (torch.as_tensor(a) for a in inputs(256, seed=2))
    fm = j2_cuda.to_feature_major(eps, eps_p, p)
    out_fm = j2_cuda.from_feature_major(*j2_cuda.j2_radial_return(*fm, el, law, **j2_cuda.J2_FAST_CONTRACT))
    out_pm = j2_cuda.j2_radial_return(eps, eps_p, p, el, law, feature_major=False, **j2_cuda.J2_FAST_CONTRACT)
    for a, b in zip(out_fm, out_pm):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrapper_launches_or_raises_off_cpu():
    """A tensor that is not on the CPU never reaches the plain version: on a
    device other than CUDA the wrapper raises."""
    el, law = build(tmodels, "voce")
    meta = [torch.empty((6, 128), device="meta"), torch.empty((6, 128), device="meta"),
            torch.empty((1, 128), device="meta")]
    with pytest.raises(ValueError, match="unsupported device"):
        j2_cuda.j2_radial_return(*meta, el, law, **j2_cuda.J2_FAST_CONTRACT)
    # the four shipped laws have a closed form in the kernel; a user callable
    # runs there as a law program
    assert all(j2_cuda.kernel_law(build(tmodels, name)[1])[0] < LAW_PROGRAM for name in LAWS)
    assert j2_cuda.kernel_law(lambda p: SIG0 + 2e3 * p)[0] == LAW_PROGRAM


CONTRACTS = {"pallas": j2_cuda.PALLAS_CONTRACT, "j2_fast": j2_cuda.J2_FAST_CONTRACT}


def kernel_hardening(law_id, h, p):
    """Value and slope of the hardening curve from a launch's packed
    parameters, as ``hardening()`` in csrc/j2_radial_return.cu evaluates
    them."""
    h0, h1, h2, h3 = h
    if law_id == 0:
        return h0 + h1 * p, np.full_like(p, h1)
    if law_id == 1:
        e = np.exp(-h2 * p)
        return h0 + (h1 - h0) * (1.0 - e), (h1 - h0) * (h2 * e)
    if law_id == 2:
        base = 1.0 + p / h1
        return h0 * base**h2, h0 * h2 * base ** (h2 - 1.0) / h1
    above = p >= h3
    x = np.where(above, p, h3) * h1
    return h0 * x**h2, np.where(above, h0 * h2 * h1 * x ** (h2 - 1.0), 0.0)


@pytest.mark.parametrize("factored", [False, True])
@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("law", sorted(LAWS))
def test_launch_packs_the_model(law, contract, factored):
    """A launch's parameter block is the JAX model's: mu and lambda, the
    Mandel stiffness of ``tensors.isotropic_C`` (the C66 of the Pallas
    kernel), a hardening curve whose closed form gives the JAX law's value
    and slope, and the contract's regularizer."""
    el, hard = build(tmodels, law)
    jel, jhard = build(jmodels, law)
    c = CONTRACTS[contract]
    launch = j2_cuda.J2Launch(el, hard, factored=factored, **c)
    params = launch.params
    assert params.dtype == np.float64 and params.shape == (43,)
    assert launch.law_id == hard.kernel_law()[0]
    assert launch.width == (2 if factored else 36)
    assert launch.contract == dict(n_iter=c["n_iter"], warm_start=c["warm_start"], reg=c["reg"])
    np.testing.assert_allclose(params[:2], [float(jel.mu), float(jel.lmbda)], rtol=1e-15)
    assert params[6] == c["reg"]
    np.testing.assert_array_equal(params[7:].reshape(6, 6), np.asarray(jtensors.isotropic_C(E, NU)))
    p = np.array([0.0, 1e-6, 1e-3, 5e-3, 2e-2])
    Y, dY = kernel_hardening(launch.law_id, params[2:6], p)
    np.testing.assert_allclose(Y, np.asarray(jhard(jnp.asarray(p))), rtol=1e-12)
    np.testing.assert_allclose(dY, np.asarray(jax.vmap(jax.grad(jhard))(jnp.asarray(p))), rtol=1e-12, atol=1e-9)


def fast_path_material():
    el, law = build(tmodels, "voce")
    mat = tdm.Material(tmodels.vonMisesIsotropicHardening(el, law), device="cpu")
    eps, eps_p, p = inputs(64, seed=3)
    mat.set_data_manager(64)
    mat.set_initial_state_dict({"eps_p": eps_p, "p": p})
    return mat, eps


@pytest.mark.parametrize("change", ["update_in_place", "update_elasticity", "swap_elasticity", "swap_law"])
def test_cached_launch_follows_the_model(change):
    """The fast path builds its launch once and keeps it while the model
    stays; a new E through update_material_property (even on the same
    elasticity object, changed in place) or another elasticity or law object
    gives a new launch with the new parameters, and the update follows it."""
    mat, eps = fast_path_material()
    beh = mat.behavior
    mat.integrate(eps)
    launch = beh._fast.launch
    mat.integrate(eps)
    assert beh._fast.launch is launch  # built once, then reused
    if change == "update_in_place":
        beh.elasticity.E = 2 * E
        mat.update_material_property("elasticity", beh.elasticity)
    elif change == "update_elasticity":
        mat.update_material_property("elasticity", tmodels.LinearElasticIsotropic(2 * E, NU))
    elif change == "swap_elasticity":
        beh.elasticity = tmodels.LinearElasticIsotropic(2 * E, NU)
    else:
        beh.yield_stress = tmodels.LinearHardening(2 * SIG0, 2e3)
    sig, _, Ct = mat.integrate(eps)
    new = beh._fast.launch
    assert new is not launch
    el = tmodels.LinearElasticIsotropic(2 * E, NU) if change != "swap_law" else build(tmodels, "voce")[0]
    law = beh.yield_stress
    np.testing.assert_array_equal(new.params, j2_cuda.pack_params(el, law.kernel_law()[1], j2_cuda.J2_FAST_CONTRACT["reg"]))
    assert new.law_id == law.kernel_law()[0]
    # and the update is the one of the new model
    s0 = mat.data_manager.s0
    want = make_j2_batched_update(el, law)(
        torch.as_tensor(eps), {"eps_p": s0["eps_p"], "p": s0["p"].reshape(-1)}, 0.0)
    torch.testing.assert_close(sig, want[0], rtol=0, atol=0)
    torch.testing.assert_close(Ct, want[1], rtol=0, atol=0)
