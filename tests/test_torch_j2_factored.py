"""The port's factored-tangent J2 return map (plain version of the CUDA kernel)
and ``expand_factored_tangent`` against the JAX package.

- float32, the inputs of tests/test_pallas_j2.py::test_pallas_factored_kernel_matches:
  the port's ``(sig, fac, eps_p, p)`` and its expanded ``Ct`` against
  ``make_j2_pallas_factored(..., tile=128, interpret=True)`` and the JAX
  ``expand_factored_tangent``. Tolerances as that test: stress 2e-4 of its
  scale, tangent 5e-4 E, state 1e-6 (f32 rounding through the hardening
  Newton); ``fac`` is a tangent coefficient, so 5e-4 E as well.
- float64: the expansion of the factored form against the port's own
  full-tangent plain version on the same inputs, to 1e-12 E (the two differ
  only in where nbar is taken: s_tr/q_tr against dev(sig)/q(sig)), and stress
  and state to the last bit; the four hardening laws, both layouts, both
  contracts.
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.ops import pallas_j2  # noqa: E402

from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.ops import j2_cuda  # noqa: E402

torch.set_num_threads(1)

E, NU, SIG0 = 70e3, 0.3, 350.0

LAWS = {
    "linear": ("LinearHardening", (SIG0, 2e3)),
    "voce": ("VoceHardening", (SIG0, 500.0, 1e3)),
    "swift": ("SwiftHardening", (SIG0, 2e-3, 0.2)),
    "ramberg_osgood": ("RambergOsgoodHardening", (SIG0, E, 2e-3, 5.0)),
}
CONTRACTS = {"pallas": j2_cuda.PALLAS_CONTRACT, "j2_fast": j2_cuda.J2_FAST_CONTRACT}


def build(pkg, law):
    cls, args = LAWS[law]
    return pkg.LinearElasticIsotropic(E, NU), getattr(pkg, cls)(*args)


def pallas_test_inputs(n=512):
    """Feature-major f32 inputs of tests/test_pallas_j2.py:67-73."""
    rng = np.random.default_rng(1)
    eps = (rng.normal(size=(n, 6)) * np.geomspace(1e-4, 4e-2, n)[:, None]).astype(np.float32)
    return eps.T.copy(), np.zeros((6, n), np.float32), np.zeros((1, n), np.float32)


def prior_state_inputs(n, seed):
    rng = np.random.default_rng(seed)
    eps = rng.normal(size=(n, 6)) * np.geomspace(1e-4, 4e-2, n)[:, None]
    eps_p = 1e-3 * rng.normal(size=(n, 6))
    eps_p[:, :3] -= eps_p[:, :3].mean(axis=1, keepdims=True)
    return eps, eps_p, 5e-3 * rng.random(n)


@pytest.mark.parametrize("law", sorted(LAWS))
def test_factored_matches_pallas_interpret_f32(law):
    fm = pallas_test_inputs()
    el_j, law_j = build(jmodels, law)
    sig_j, fac_j, epsp_j, p_j = pallas_j2.make_j2_pallas_factored(
        el_j, law_j, tile=128, interpret=True
    )(*(jnp.asarray(a) for a in fm))
    Ct_j = pallas_j2.expand_factored_tangent(el_j, sig_j, fac_j)

    el, hard = build(tmodels, law)
    sig, fac, epsp, p = j2_cuda.j2_radial_return_factored(
        *(torch.as_tensor(a) for a in fm), el, hard, **j2_cuda.PALLAS_CONTRACT
    )
    Ct = j2_cuda.expand_factored_tangent(el, sig, fac)
    assert sig.dtype == torch.float32 and fac.shape == (2, 512) and Ct.shape == (36, 512)
    assert float(p.max()) > 1e-3, "must exercise the plastic branch"

    def err(a, b):
        return float(np.max(np.abs(a.numpy() - np.asarray(b))))

    assert err(sig, sig_j) <= 2e-4 * float(np.abs(np.asarray(sig_j)).max())
    assert err(fac, fac_j) <= 5e-4 * E
    assert err(Ct, Ct_j) <= 5e-4 * E
    assert err(p, p_j) <= 1e-6
    assert err(epsp, epsp_j) <= 1e-6


@pytest.mark.parametrize("law", sorted(LAWS))
@pytest.mark.parametrize("contract", sorted(CONTRACTS))
@pytest.mark.parametrize("feature_major", [True, False])
def test_factored_expands_to_full_tangent_f64(law, contract, feature_major):
    el, hard = build(tmodels, law)
    eps, eps_p, p = prior_state_inputs(384, seed=2)
    args = [eps.T, eps_p.T, p[None, :]] if feature_major else [eps, eps_p, p]
    args = [torch.as_tensor(np.ascontiguousarray(a)) for a in args]
    kw = dict(CONTRACTS[contract], feature_major=feature_major)
    sig, fac, epsp, pn = j2_cuda.j2_radial_return_factored(*args, el, hard, **kw)
    sig_f, Ct_f, epsp_f, pn_f = j2_cuda.j2_radial_return_reference(*args, el, hard, **kw)
    n = eps.shape[0]
    assert tuple(fac.shape) == ((2, n) if feature_major else (n, 2))
    assert float((pn - args[2]).max()) > 1e-3, "must exercise the plastic branch"
    for a, b in ((sig, sig_f), (epsp, epsp_f), (pn, pn_f)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    Ct = j2_cuda.expand_factored_tangent(el, sig, fac, feature_major=feature_major)
    assert Ct.shape == Ct_f.shape
    assert float((Ct - Ct_f).abs().max()) <= 1e-12 * E
    # elastic points carry fac = 0 exactly
    elastic = (pn == args[2]).reshape(-1)
    fac_rows = fac.T if feature_major else fac
    assert elastic.any() and float(fac_rows[elastic].abs().max()) == 0.0


def test_expand_handles_zero_stress():
    """q = 0 (no stress at all): 1/q is taken as 0, so Ct = C exactly."""
    el, _ = build(tmodels, "voce")
    sig = torch.zeros((6, 4), dtype=torch.float64)
    fac = torch.ones((2, 4), dtype=torch.float64)
    Ct = j2_cuda.expand_factored_tangent(el, sig, fac)
    from dolfinx_materials_tpu_torch.ops import tensors

    want = torch.as_tensor(tensors.isotropic_C(E, NU) - tensors.K4).reshape(36, 1).expand(36, 4)
    torch.testing.assert_close(Ct, want, rtol=0, atol=0)
    want_j = pallas_j2.expand_factored_tangent(build(jmodels, "voce")[0], jnp.zeros((6, 4)), jnp.ones((2, 4)))
    np.testing.assert_allclose(Ct.numpy(), np.asarray(want_j), rtol=0, atol=1e-12 * E)


def test_factored_wrapper_launches_or_raises_off_cpu():
    el, hard = build(tmodels, "voce")
    meta = [torch.empty(s, device="meta") for s in ((6, 128), (6, 128), (1, 128))]
    with pytest.raises(ValueError, match="unsupported device"):
        j2_cuda.j2_radial_return_factored(*meta, el, hard, **j2_cuda.J2_FAST_CONTRACT)
