"""The port's matrix functions (``ops/matfun.py`` per point, ``ops/
matfun_fm.py`` feature-major and tuple forms) against the JAX package's, in
float64 on the CPU, on the same SPD inputs made from a numpy seed.
Tolerances are those of tests/test_matfun.py: logm and sqrtm 1e-10, powm
1e-9, gradients at coincident eigenvalues 1e-9."""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu.ops import matfun as jmf  # noqa: E402
from dolfinx_materials_tpu.ops import matfun_fm as jfm  # noqa: E402

from dolfinx_materials_tpu_torch.ops import matfun as tmf  # noqa: E402
from dolfinx_materials_tpu_torch.ops import matfun_fm as tfm  # noqa: E402

torch.set_num_threads(1)


def rand_spd(rng, n, spread=2.0):
    Q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    lam = np.exp(rng.uniform(-spread, spread, size=(n, 1, 3)))
    return (Q * lam) @ Q.transpose(0, 2, 1)


def spd_batch(seed=0, n=8):
    """Random SPD matrices, the identity, 2I and one with two coincident
    eigenvalues."""
    X = rand_spd(np.random.default_rng(seed), n)
    Q, _ = np.linalg.qr(np.random.default_rng(seed + 1).normal(size=(3, 3)))
    pair = (Q * np.array([1.3, 1.3, 0.7])) @ Q.T
    return np.concatenate([X, np.eye(3)[None], 2.0 * np.eye(3)[None], pair[None]])


def close(a, b, rtol):
    a, b = np.asarray(a), np.asarray(b)
    np.testing.assert_allclose(a, b, rtol=rtol, atol=rtol * np.abs(b).max())


PER_POINT = {
    "sqrtm": (lambda m, X: m.sqrtm(X), 1e-10),
    "inv_spd": (lambda m, X: m.inv_spd(X), 1e-10),
    "logm": (lambda m, X: m.logm(X), 1e-10),
    "expm": (lambda m, X: m.expm(0.3 * X), 1e-10),
    "powm": (lambda m, X: m.powm(X, 14.4), 1e-9),
    "tr_powm": (lambda m, X: m.tr_powm(X, 3.7), 1e-9),
}


@pytest.mark.parametrize("name", sorted(PER_POINT))
def test_per_point_matches_jax(name):
    fn, rtol = PER_POINT[name]
    X = spd_batch()
    close(fn(tmf, torch.tensor(X)), fn(jmf, jnp.asarray(X)), rtol)


def test_inv_near_and_sqrtm_ns_match_jax():
    X = spd_batch(seed=4)
    Xn = np.eye(3) + 0.1 * (X / np.abs(X).max())
    close(tmf._inv_near(torch.tensor(Xn), 0.5 * torch.eye(3, dtype=torch.float64).expand(Xn.shape)),
          jmf._inv_near(jnp.asarray(Xn), 0.5 * jnp.broadcast_to(jnp.eye(3), Xn.shape)), 1e-10)
    for a, b in zip(tmf.sqrtm_ns(torch.tensor(X)), jmf.sqrtm_ns(jnp.asarray(X))):
        close(a, b, 1e-10)


def fm(X):
    return np.ascontiguousarray(np.moveaxis(X, 0, -1))


FEATURE_MAJOR = {
    "sqrtm_ns": (lambda m, A: m.sqrtm_ns(A)[0], 1e-10),
    "logm": (lambda m, A: m.logm(A), 1e-10),
    "expm": (lambda m, A: m.expm(0.3 * A), 1e-10),
    "logm_gregory": (lambda m, A: m.logm_gregory(A), 1e-10),
    "expm_unrolled": (lambda m, A: m.expm_unrolled(0.1 * A), 1e-10),
    "inv33": (lambda m, A: m.inv33(A), 1e-12),
    "bmm": (lambda m, A: m.bmm(A, m.transpose(A)), 1e-13),
    "det": (lambda m, A: m.det(A), 1e-12),
    "trace": (lambda m, A: m.trace(A), 1e-13),
    "eigvals_sym": (lambda m, A: np.stack([np.asarray(x) for x in m.eigvals_sym(A)]), 1e-10),
    "sym_cols": (lambda m, A: m.from_sym_cols(m.to_sym_cols(A)), 1e-13),
    "nonsym_rows": (lambda m, A: m.from_nonsym_rows(m.to_nonsym_rows(A)), 0.0),
}


@pytest.mark.parametrize("name", sorted(FEATURE_MAJOR))
def test_feature_major_matches_jax(name):
    fn, rtol = FEATURE_MAJOR[name]
    X = spd_batch(seed=2)
    if name == "logm_gregory":
        X = np.eye(3) + 0.3 * X / np.abs(X).max()
    close(fn(tfm, torch.tensor(fm(X))), fn(jfm, jnp.asarray(fm(X))), rtol)


TUPLE = ("t_bmm", "t_transpose", "t_add", "t_scale", "t_inv33", "t_eye_like")


def flat(T):
    return np.stack([np.asarray(T[i][j]) for i in range(3) for j in range(3)])


@pytest.mark.parametrize("name", TUPLE)
def test_tuple_algebra_matches_jax(name):
    rng = np.random.default_rng(5)
    v = rng.normal(size=(16, 9)) + np.array([1, 1, 1, 0, 0, 0, 0, 0, 0.0])
    out = {}
    for key, m, arr in (("t", tfm, torch.tensor(v)), ("j", jfm, jnp.asarray(v))):
        A = m.t_from_nonsym_rows(arr)
        f = getattr(m, name)
        out[key] = {
            "t_bmm": lambda: f(A, m.t_transpose(A)),
            "t_transpose": lambda: f(A),
            "t_add": lambda: f(A, A),
            "t_scale": lambda: f(2.5, A),
            "t_inv33": lambda: f(A),
            "t_eye_like": lambda: f(A),
        }[name]()
    close(flat(out["t"]), flat(out["j"]), 1e-12)


def test_tuple_scalars_match_jax():
    X = spd_batch(seed=6)
    v = fm(X).reshape(9, -1).T[:, [0, 4, 8, 1, 3, 2, 6, 5, 7]]  # nonsym rows
    out = []
    for m, arr in ((tfm, torch.tensor(v)), (jfm, jnp.asarray(v))):
        A = m.t_from_nonsym_rows(arr)
        out.append([m.t_det(A), m.t_trace(A), *m.t_eigvals_sym(A)])
    for a, b in zip(*out):
        close(a, b, 1e-10)


@pytest.mark.parametrize("C0", ["2I", "pair"])
def test_grad_at_coincident_eigenvalues_matches_jax(C0):
    """d tr(log C)/dC at C = 2I (= C^-1) and at a pair of coincident
    eigenvalues, and d tr(C^a)/dC there, through both packages' AD: finite
    and equal to 1e-9."""
    X = spd_batch()[-2 if C0 == "2I" else -1]
    for fn in (lambda m, C: m.logm(C)[..., 0, 0] + m.logm(C)[..., 1, 1] + m.logm(C)[..., 2, 2],
               lambda m, C: m.tr_powm(C, 3.7)):
        gt = torch.func.grad(lambda C: fn(tmf, C))(torch.tensor(X))
        gj = jax.grad(lambda C: fn(jmf, C))(jnp.asarray(X))
        assert bool(torch.isfinite(gt).all())
        close(gt, gj, 1e-9)
    if C0 == "2I":
        close(gt.new_tensor(np.asarray(gj)), 3.7 * 2.0**2.7 * np.eye(3), 1e-9)


def test_eigvals_sym_gradient_at_the_identity_is_finite_in_f32():
    """The dtype-aware guards keep the Cardano gradient finite at F = I in
    float32, as in the JAX package."""
    A = torch.eye(3, dtype=torch.float32)[:, :, None].repeat(1, 1, 4).requires_grad_(True)
    sum(tfm.eigvals_sym(A)[k].pow(2).sum() for k in range(3)).backward()
    assert bool(torch.isfinite(A.grad).all())
