"""The port's NN surrogate (``models/nn.py``), its reverse mode through the
implicit-function-theorem roots (``ops/newton.py`` ``_Root.backward``) and
its calibration (``calibration.py``) against the JAX package's, in float64
on the CPU:

- ``init_mlp_params`` bitwise equal, ``state.from_reference_params`` round trip;
- the surrogate's flux and tangent through ``Material`` to 1e-12 of scale;
- ``NeuralBehavior.fit`` for 50 Adam steps against optax's: the loss
  history to 1e-8 relative;
- gradients through one ``newton_solve`` root and one
  ``scalar_newton_solve`` root against ``jax.grad`` through ``custom_root``
  to 1e-10 relative, also under ``grad(vmap(...))``, with a closed-over
  parameter, and against a central difference (tests/test_calibration.py's
  check, 1e-5); a closed-over parameter six objects deep converted, one in
  a tuple or a module global refused with ``TypeError``;
- ``fit_parameters`` for 20 steps on tests/test_calibration.py's Voce path
  against the JAX one: losses and fitted parameters to 1e-8 relative.
"""

import numpy as np
import pytest
import torch
from torch.func import grad, vmap

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import dolfinx_materials_tpu as jdm  # noqa: E402
from dolfinx_materials_tpu import calibration as jcal  # noqa: E402
from dolfinx_materials_tpu import models as jmodels  # noqa: E402
from dolfinx_materials_tpu.models import nn as jnn  # noqa: E402
from dolfinx_materials_tpu.ops import newton as jnewton  # noqa: E402

import dolfinx_materials_tpu_torch as tdm  # noqa: E402
from dolfinx_materials_tpu_torch import calibration as tcal  # noqa: E402
from dolfinx_materials_tpu_torch import models as tmodels  # noqa: E402
from dolfinx_materials_tpu_torch.models import nn as tnn  # noqa: E402
from dolfinx_materials_tpu_torch.ops import newton as tnewton  # noqa: E402
from dolfinx_materials_tpu_torch.state import from_reference_params  # noqa: E402

torch.set_num_threads(1)
E, NU = 70e3, 0.3
LAYERS = (6, 16, 16, 6)


def relerr(a, b):
    a, b = np.asarray(a, dtype=float), np.asarray(b, dtype=float)
    return float(np.abs(a - b).max() / np.abs(b).max())


def test_init_params_bitwise_and_round_trip():
    pt, pj = tnn.init_mlp_params(LAYERS, seed=7), jnn.init_mlp_params(LAYERS, seed=7)
    for a, b in zip(pt, pj):
        np.testing.assert_array_equal(a["W"], np.asarray(b["W"]))
        np.testing.assert_array_equal(a["b"], np.asarray(b["b"]))
    beh = tmodels.NeuralBehavior(layers=LAYERS, params=pj)
    state = from_reference_params(pj)
    assert state["linears.0.weight"].shape == (16, 6)
    for a, b in zip(beh.params, pj):
        np.testing.assert_array_equal(a["W"], np.asarray(b["W"]))
        np.testing.assert_array_equal(a["b"], np.asarray(b["b"]))
    np.testing.assert_array_equal(tmodels.NeuralBehavior(layers=LAYERS, seed=7).params[1]["W"], pt[1]["W"])


def test_flux_and_tangent_match_jax():
    rng = np.random.default_rng(0)
    eps = rng.normal(size=(12, 6)) * 1e-3
    mt = tdm.Material(tmodels.NeuralBehavior(layers=LAYERS, seed=1, output_scale=100.0), device="cpu")
    mj = jdm.Material(jmodels.NeuralBehavior(layers=LAYERS, seed=1, output_scale=100.0))
    st, _, Ct = mt.integrate(eps)
    sj, _, Cj = mj.integrate(jnp.asarray(eps))
    assert relerr(st, sj) <= 1e-12
    assert relerr(Ct, Cj) <= 1e-12
    x = torch.tensor(eps) * 1e3
    np.testing.assert_allclose(tnn.mlp_apply([{k: torch.as_tensor(v) for k, v in p.items()}
                                              for p in mt.behavior.params], x).numpy(),
                               mt.behavior.module(x).detach().numpy(), rtol=1e-13, atol=1e-13)


def test_fit_matches_optax():
    rng = np.random.default_rng(0)
    eps = rng.normal(size=(256, 6)) * 1e-3
    sig = eps @ tmodels.LinearElasticIsotropic(E, NU).C.T
    bt = tmodels.NeuralBehavior(layers=LAYERS, input_scale=1e3, output_scale=100.0)
    bj = jmodels.NeuralBehavior(layers=LAYERS, input_scale=1e3, output_scale=100.0)
    ht = bt.fit(eps, sig, steps=50, learning_rate=3e-3, device="cpu")
    hj = bj.fit(eps, sig, steps=50, learning_rate=3e-3)
    assert ht[-1] < 0.5 * ht[0]
    assert np.abs(np.array(ht) / np.array(hj) - 1.0).max() <= 1e-8
    for a, b in zip(bt.params, bj.params):
        assert relerr(a["W"], b["W"]) <= 1e-8


def cubic(pkg, mod):
    """A two-unknown residual with a closed-over parameter ``theta`` and a
    per-point argument ``a``: x0^3 + theta x1 = a, x1 = x0 / 2 + a / 10."""

    def f(theta, a):
        def r(x, a_):
            return mod.stack([x[0] ** 3 + theta * x[1] - a_, x[1] - 0.5 * x[0] - 0.1 * a_])

        x, _ = pkg.newton_solve(r, mod.zeros(2, dtype=mod.float64), args=(a,), tol=1e-14)
        return x[0] + 2.0 * x[1] ** 2

    return f


def scalar(pkg, mod, maximum):
    """J2-like scalar root: f_act - 3 mu dp - H(p + dp) with f_act = max(q - s, 0)."""

    def f(theta, q):
        def r(dp, f_act):
            return f_act - 300.0 * dp - theta * (1.0 - mod.exp(-50.0 * dp))

        f_act = maximum(q - 1.0, 0.0 * q)
        dp, _ = pkg.scalar_newton_solve(r, 0.0 * q, args=(f_act,), tol=1e-14, lower=0.0)
        return dp * q

    return f


CASES = {
    "vector": (cubic(tnewton, torch), cubic(jnewton, jnp)),
    "scalar": (scalar(tnewton, torch, torch.maximum), scalar(jnewton, jnp, jnp.maximum)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_root_backward_matches_custom_root(case):
    ft_, fj_ = CASES[case]
    theta, a = 2.0, 3.0
    for argnum in (0, 1):
        gt = grad(ft_, argnums=argnum)(torch.tensor(theta, dtype=torch.float64), torch.tensor(a, dtype=torch.float64))
        gj = jax.grad(fj_, argnums=argnum)(jnp.asarray(theta), jnp.asarray(a))
        assert abs(float(gt) / float(gj) - 1.0) <= 1e-10
    # reverse mode over points: grad(vmap(...)) of the summed outputs
    A = np.linspace(1.5, 4.0, 7)
    gt = grad(lambda th: vmap(lambda x: ft_(th, x))(torch.tensor(A)).sum())(torch.tensor(theta, dtype=torch.float64))
    gj = jax.grad(lambda th: jax.vmap(lambda x: fj_(th, x))(jnp.asarray(A)).sum())(jnp.asarray(theta))
    assert abs(float(gt) / float(gj) - 1.0) <= 1e-10
    ga = grad(lambda x: vmap(lambda y: ft_(torch.tensor(theta, dtype=torch.float64), y))(x).sum())(torch.tensor(A))
    gaj = jax.grad(lambda x: jax.vmap(lambda y: fj_(jnp.asarray(theta), y))(x).sum())(jnp.asarray(A))
    assert relerr(ga, gaj) <= 1e-10
    # plain autograd reaches the same gradient
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    ft_(th, torch.tensor(a, dtype=torch.float64)).backward()
    assert abs(float(th.grad) / float(gj_theta(fj_, theta, a)) - 1.0) <= 1e-10


def gj_theta(fj_, theta, a):
    return jax.grad(fj_)(jnp.asarray(theta), jnp.asarray(a))


GLOBAL_HOLD = {}


class Box:
    def __init__(self, inner):
        self.inner = inner


def cubic_reading(hold, get):
    """``cubic``'s residual with theta read by ``get(hold)``, ``hold``
    captured by the residual's closure; the output also adds theta, so it
    requires grad whatever the root gives."""

    def f(theta, a):
        def r(x, a_):
            return torch.stack([x[0] ** 3 + get(hold) * x[1] - a_, x[1] - 0.5 * x[0] - 0.1 * a_])

        x, _ = tnewton.newton_solve(r, torch.zeros(2, dtype=torch.float64), args=(a,), tol=1e-14)
        return x[0] + 2.0 * x[1] ** 2 + theta

    return f


def deep(theta):
    return Box(Box(Box(Box(Box(Box([theta]))))))


def read_deep(hold):
    return hold.inner.inner.inner.inner.inner.inner[0]


CAPTURES = {
    # (how theta is held, how the residual reads it, how the gradient is taken, the error or None)
    "tuple-autograd": (lambda th: (th,), lambda h: h[0], "autograd", TypeError),
    "tuple-grad": (lambda th: (th,), lambda h: h[0], "grad", TypeError),
    "global-autograd": (lambda th: GLOBAL_HOLD.update(theta=th), lambda h: GLOBAL_HOLD["theta"], "autograd",
                        TypeError),
    "deep-autograd": (deep, read_deep, "autograd", None),
    "deep-grad": (deep, read_deep, "grad", None),
}


@pytest.mark.parametrize("case", sorted(CAPTURES))
def test_root_closure_capture_converted_or_refused(case):
    """A differentiated tensor that the residual closes over is turned into an
    argument at any depth (the gradient of jax.grad through custom_root, plus
    the output's direct 1, to 1e-10); one the roots cannot turn into an
    argument raises TypeError instead of losing its derivative."""
    make_hold, get, mode, error = CAPTURES[case]
    theta, a = 2.0, torch.tensor(3.0, dtype=torch.float64)

    def gradient():
        th = torch.tensor(theta, dtype=torch.float64, requires_grad=mode == "autograd")
        if mode == "grad":
            return grad(lambda t: cubic_reading(make_hold(t), get)(t, a))(th)
        cubic_reading(make_hold(th), get)(th, a).backward()
        return th.grad

    try:
        if error is not None:
            with pytest.raises(error, match="residual"):
                gradient()
            return
        expected = float(gj_theta(CASES["vector"][1], theta, 3.0)) + 1.0
        assert abs(float(gradient()) / expected - 1.0) <= 1e-10
    finally:
        GLOBAL_HOLD.clear()


TRUE = dict(sig0=350.0, sigu=500.0, b=1e3)


def voce_factory(m, exp):
    def factory(th):
        return m.vonMisesIsotropicHardening(
            m.LinearElasticIsotropic(E, NU),
            m.VoceHardening(TRUE["sig0"] * exp(th["ls0"]), TRUE["sigu"] * exp(th["lsu"]), TRUE["b"] * exp(th["lb"])))

    return factory


def strain_path(nsteps):
    path = np.zeros((nsteps, 6))
    path[:, 0] = np.linspace(0, 4 * 350.0 / 70e3, nsteps + 1)[1:]
    return path


def test_path_gradient_matches_jax_and_central_difference():
    th0 = {k: torch.tensor(0.0, dtype=torch.float64) for k in ("ls0", "lsu", "lb")}
    sim = tcal.make_path_simulator(voce_factory(tmodels, torch.exp), th0)
    path = torch.tensor(strain_path(10))

    def loss(th):
        return torch.sum(sim(th, path) ** 2)

    g = grad(loss)(th0)
    jsim = jcal.make_path_simulator(voce_factory(jmodels, jnp.exp), {k: jnp.asarray(0.0) for k in th0})
    gj = jax.grad(lambda th: jnp.sum(jsim(th, jnp.asarray(path.numpy())) ** 2))({k: jnp.asarray(0.0) for k in th0})
    for k in th0:
        assert abs(float(g[k]) / float(gj[k]) - 1.0) <= 1e-10
    h = 1e-5
    shifted = [dict(th0, ls0=torch.tensor(s * h, dtype=torch.float64)) for s in (1, -1)]
    fd = (float(loss(shifted[0])) - float(loss(shifted[1]))) / (2 * h)
    np.testing.assert_allclose(float(g["ls0"]), fd, rtol=1e-5)
    # batched over points: grad of the vmapped path
    path3 = torch.stack([path, 0.5 * path, 1.2 * path], dim=1)
    g3 = grad(lambda th: torch.sum(sim(th, path3) ** 2))(th0)
    g3j = jax.grad(lambda th: jnp.sum(jsim(th, jnp.asarray(path3.numpy())) ** 2))({k: jnp.asarray(0.0) for k in th0})
    for k in th0:
        assert abs(float(g3[k]) / float(g3j[k]) - 1.0) <= 1e-10


def test_fit_parameters_matches_jax():
    path = strain_path(20)
    theta_true = {k: torch.tensor(0.0, dtype=torch.float64) for k in ("ls0", "lsu", "lb")}
    target = tcal.make_path_simulator(voce_factory(tmodels, torch.exp), theta_true)(theta_true, torch.tensor(path))
    theta0 = {"ls0": np.log(0.8), "lsu": np.log(1.25), "lb": np.log(0.6)}
    fit_t, hist_t = tcal.fit_parameters(voce_factory(tmodels, torch.exp), theta0, path, target.numpy(), steps=20,
                                        learning_rate=0.05, device="cpu")
    fit_j, hist_j = jcal.fit_parameters(voce_factory(jmodels, jnp.exp), {k: jnp.asarray(v) for k, v in theta0.items()},
                                        jnp.asarray(path), jnp.asarray(target.numpy()), steps=20, learning_rate=0.05)
    assert hist_t[-1] < 0.5 * hist_t[0]
    assert np.abs(np.array(hist_t) / np.array(hist_j) - 1.0).max() <= 1e-8
    for k in theta0:
        assert abs(float(fit_t[k]) / float(fit_j[k]) - 1.0) <= 1e-8
