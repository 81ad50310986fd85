"""The port's IFT Newton solvers (ops/newton.py) against the JAX package's.

The same residuals, written once per framework, on the same numpy inputs,
batched with ``vmap`` and differentiated with ``jacfwd`` as the constitutive
tangents are. float64. Roots and Jacobians to 1e-10: both sides stop their
iteration at the same tolerance (1e-10 on the residual, or tighter), so the
roots agree to that tolerance over the residual's slope (of order one here),
and the IFT derivative is evaluated at those roots.
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu.ops import newton as jn  # noqa: E402

from dolfinx_materials_tpu_torch.ops import newton as tn  # noqa: E402

torch.set_num_threads(1)
TOL = 1e-10


def close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    assert float(np.abs(got - want).max()) <= tol * max(1.0, float(np.abs(want).max()))


def both(f_t, f_j, a):
    """Values and Jacobians of ``vmap(f)`` / ``vmap(jacfwd(f))`` on rows of a."""
    at, aj = torch.as_tensor(a), jnp.asarray(a)
    return (
        (torch.func.vmap(f_t)(at).numpy(), torch.func.vmap(torch.func.jacfwd(f_t))(at).numpy()),
        (np.asarray(jax.vmap(f_j)(aj)), np.asarray(jax.vmap(jax.jacfwd(f_j))(aj))),
    )


def cubic(pkg, xp, a, tol=1e-12):
    x, ok = pkg.scalar_newton_solve(lambda x, a: x**3 + x - a, xp.zeros_like(a), args=(a,), tol=tol)
    return x


def test_scalar_root_and_ift_derivative():
    a = np.linspace(-3.0, 3.0, 13)
    (x_t, J_t), (x_j, J_j) = both(lambda a: cubic(tn, torch, a), lambda a: cubic(jn, jnp, a), a)
    close(x_t, x_j)
    close(J_t, J_j)
    close(J_t, 1.0 / (3.0 * x_t**2 + 1.0), 1e-12)  # the closed-form IFT slope


def test_scalar_root_unbatched_and_converged_flag():
    x, ok = tn.scalar_newton_solve(lambda x, a: x**3 + x - a, torch.zeros((), dtype=torch.float64),
                                   args=(torch.tensor(2.0, dtype=torch.float64),))
    assert bool(ok) and abs(float(x) - 1.0) < 1e-10
    # one iteration cannot converge from 0: the flag says so
    x, ok = tn.scalar_newton_solve(lambda x, a: x**3 + x - a, torch.zeros((), dtype=torch.float64),
                                   args=(torch.tensor(2.0, dtype=torch.float64),), max_iter=1)
    assert not bool(ok)
    close(float(x), float(jn.scalar_newton_solve(lambda x, a: x**3 + x - a, jnp.zeros(()),
                                                 args=(jnp.asarray(2.0),), max_iter=1)[0]))


def plastic_like(pkg, xp, clamp0, v):
    """A return-map-like residual: f_act = max(f, 0) puts elastic points at
    the root x = 0 exactly, and full Newton steps from 0 overshoot below 0 on
    the convex hardening curve, so the projection x >= 0 is active."""
    f, h = v[0], v[1]

    def res(x, f_act, h):
        return f_act - 3.0 * x - h * (xp.exp(4.0 * x) - 1.0)

    x, _ = pkg.scalar_newton_solve(res, xp.zeros_like(f), args=(clamp0(f), h), tol=1e-12, lower=0.0)
    return x


def test_scalar_root_with_lower_bound_and_elastic_branch():
    rng = np.random.default_rng(0)
    v = np.stack([rng.normal(size=24) * 2.0, 0.5 + rng.random(24)], axis=1)
    (x_t, J_t), (x_j, J_j) = both(
        lambda v: plastic_like(tn, torch, lambda f: torch.clamp(f, min=0.0), v),
        lambda v: plastic_like(jn, jnp, lambda f: jnp.maximum(f, 0.0), v),
        v,
    )
    elastic = v[:, 0] <= 0
    assert elastic.any() and (~elastic).any()
    assert (x_t[elastic] == 0.0).all() and (J_t[elastic] == 0.0).all()
    assert (x_t[~elastic] > 0.0).all()
    close(x_t, x_j)
    close(J_t, J_j)


def vector_root(pkg, xp, stack, a):
    """A 2-unknown system with an arctan row (plus a small slope, so a root
    always exists): from the far start (8, -6) a full Newton step overshoots,
    so the backtracking is exercised."""

    def res(x, a):
        return stack([xp.arctan(x[0]) + 0.05 * x[0] + 0.1 * x[1] - a[0],
                      x[1] ** 3 + x[1] + 0.2 * x[0] - a[1]])

    x0 = xp.ones(2) * a[0] * 0.0 + stack([a[0] * 0.0 + 8.0, a[0] * 0.0 - 6.0])
    x, ok = pkg.newton_solve(res, x0, args=(a,), tol=1e-12, max_iter=60)
    return x


def test_vector_root_with_backtracking_and_ift_jacobian():
    rng = np.random.default_rng(1)
    a = np.stack([rng.uniform(-1.0, 1.0, 16), rng.uniform(-3.0, 3.0, 16)], axis=1)
    (x_t, J_t), (x_j, J_j) = both(
        lambda a: vector_root(tn, torch, torch.stack, a),
        lambda a: vector_root(jn, jnp, jnp.stack, a),
        a,
    )
    res = np.stack([np.arctan(x_t[:, 0]) + 0.05 * x_t[:, 0] + 0.1 * x_t[:, 1] - a[:, 0],
                    x_t[:, 1] ** 3 + x_t[:, 1] + 0.2 * x_t[:, 0] - a[:, 1]], axis=1)
    assert float(np.abs(res).max()) < 1e-11, "every point must converge from the far start"
    close(x_t, x_j)
    close(J_t, J_j)


def test_full_newton_step_alone_fails_where_backtracking_converges():
    """The far start really needs the damping: with max_backtracks=0 the
    port's solver does not converge from it."""
    a = torch.tensor([0.3, 1.0], dtype=torch.float64)

    def res(x, a):
        return torch.stack([torch.arctan(x[0]) + 0.05 * x[0] + 0.1 * x[1] - a[0],
                            x[1] ** 3 + x[1] + 0.2 * x[0] - a[1]])

    x0 = torch.tensor([8.0, -6.0], dtype=torch.float64)
    _, ok_damped = tn.newton_solve(res, x0, args=(a,), tol=1e-12, max_iter=60)
    _, ok_full = tn.newton_solve(res, x0, args=(a,), tol=1e-12, max_iter=60, max_backtracks=0)
    assert bool(ok_damped) and not bool(ok_full)


def nested(pkg, xp, bc):
    """A root inside a root: find y with x(y + b) = c where x solves the cubic."""
    b, c = bc[0], bc[1]

    def outer(y, b, c):
        return cubic(pkg, xp, y + b) - c

    y, _ = pkg.scalar_newton_solve(outer, xp.zeros_like(b), args=(b, c), tol=1e-12)
    return y


def test_nested_root_and_its_derivative():
    bc = np.stack([np.linspace(0.1, 1.0, 7), np.linspace(0.5, 1.5, 7)], axis=1)
    (y_t, J_t), (y_j, J_j) = both(lambda v: nested(tn, torch, v), lambda v: nested(jn, jnp, v), bc)
    close(y_t, y_j)
    close(J_t, J_j)
    c = bc[:, 1]
    close(y_t, c**3 + c - bc[:, 0])  # x(y + b) = c  <=>  y = c^3 + c - b
    close(J_t, np.stack([-np.ones_like(c), 3.0 * c**2 + 1.0], axis=1))


def test_jacfwd_outside_vmap_and_per_point_tolerance():
    """jacfwd(vmap(f)) (the transforms the other way round) gives the same
    derivative, and ``tol`` may be a per-point tensor."""
    a = torch.linspace(0.5, 3.0, 6, dtype=torch.float64)
    J_in = torch.func.vmap(torch.func.jacfwd(lambda a: cubic(tn, torch, a)))(a)
    J_out = torch.func.jacfwd(torch.func.vmap(lambda a: cubic(tn, torch, a)))(a)
    close(J_out.diagonal().numpy(), J_in.numpy(), 1e-14)
    x = torch.func.vmap(lambda a: cubic(tn, torch, a, tol=1e-12 * (1.0 + a)))(a)
    close(x.numpy(), np.asarray(jax.vmap(lambda a: cubic(jn, jnp, a))(jnp.asarray(a.numpy()))))


def test_bool_argument_gets_no_tangent():
    """A mask among ``args`` selects the residual's branch and is skipped by
    the derivative pass (GeneralIsotropicHardening passes one)."""

    def f(a):
        def res(x, a, flag):
            return torch.where(flag, x - 2.0 * a, x**3 + x - a)

        x, _ = tn.scalar_newton_solve(res, torch.zeros_like(a), args=(a, a > 1.0))
        return x

    a = torch.tensor([0.5, 2.0], dtype=torch.float64)
    x = torch.func.vmap(f)(a)
    J = torch.func.vmap(torch.func.jacfwd(f))(a)
    assert abs(float(x[1]) - 4.0) < 1e-10 and abs(float(J[1]) - 2.0) < 1e-12
    assert abs(float(J[0]) - 1.0 / (3.0 * float(x[0]) ** 2 + 1.0)) < 1e-12
