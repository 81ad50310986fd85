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
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.ops.j2_fast import make_j2_batched_update as jax_j2_fast  # noqa: E402
from dolfinx_materials_tpu.ops.pallas_j2 import make_j2_pallas_update  # noqa: E402

from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.ops import j2_cuda  # noqa: E402
from dolfinx_materials_tpu_torch.ops.j2_fast import make_j2_batched_update  # noqa: E402

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
    # the four shipped laws have an in-kernel form; a user callable has none
    assert all(j2_cuda.kernel_law(build(tmodels, name)[1]) is not None for name in LAWS)
    assert j2_cuda.kernel_law(lambda p: SIG0 + 2e3 * p) is None
