"""The port's Mandel tensor algebra (ops/tensors.py) against the JAX package.

Same numpy inputs (seeded) through both; float64. Tolerance 1e-13 of each
result's scale: the two sides evaluate the same closed forms and differ only
in the order of floating-point operations (``eigh33`` eigenvalues come from
two LAPACK calls and are held to the same bar; eigenvectors are compared
through the reconstruction they give, since their sign is free). First
derivatives of ``eigvals33_smooth``, ``hosford_norm`` and the smoothed
Rankine norms of models/conic.py (forward mode, as the constitutive tangents
take them) to 1e-10 of their scale: they go through ``arccos`` near its
guarded ends.
"""

import numpy as np
import pytest
import torch

jdm = pytest.importorskip("dolfinx_materials_tpu")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from dolfinx_materials_tpu.models import conic as conic_j  # noqa: E402
from dolfinx_materials_tpu.models.plasticity import hosford_norm as hosford_j  # noqa: E402
from dolfinx_materials_tpu.ops import tensors as jt  # noqa: E402

from dolfinx_materials_tpu_torch.models import conic as conic_t  # noqa: E402
from dolfinx_materials_tpu_torch.models.plasticity import hosford_norm as hosford_t  # noqa: E402
from dolfinx_materials_tpu_torch.ops import tensors as tt  # noqa: E402

torch.set_num_threads(1)
RTOL = 1e-13


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    assert float(np.abs(got - want).max()) <= rtol * scale


RNG = np.random.default_rng(7)
V6 = RNG.normal(size=(5, 6))
W6 = RNG.normal(size=(5, 6))
V9 = RNG.normal(size=(5, 9))
M33 = RNG.normal(size=(5, 3, 3)) + 2.0 * np.eye(3)
SYM = 0.5 * (M33 + np.swapaxes(M33, -1, -2))
ROT = np.stack([np.linalg.qr(RNG.normal(size=(3, 3)))[0] for _ in range(5)])

UNARY = {
    "tr": V6, "dev": V6, "norm": V6, "eq_vm": V6, "sym_to_mat": V6, "mat_to_sym": M33,
    "nonsym_to_mat": V9, "mat_to_nonsym": M33, "transpose9": V9, "det33": M33, "inv33": M33,
    "rotation_to_mandel6": ROT, "rotation_to_9": ROT, "eigvals33_smooth": SYM,
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_function_matches_jax(name):
    a = UNARY[name]
    close(getattr(tt, name)(torch.as_tensor(a)), getattr(jt, name)(jnp.asarray(a)))


@pytest.mark.parametrize("name", ["ddot", "outer66"])
def test_binary_function_matches_jax(name):
    close(getattr(tt, name)(torch.as_tensor(V6), torch.as_tensor(W6)),
          getattr(jt, name)(jnp.asarray(V6), jnp.asarray(W6)))


def test_eq_vm_safe_and_constants_match_jax():
    close(tt.eq_vm_safe(torch.as_tensor(V6), 3.0), jt.eq_vm_safe(jnp.asarray(V6), 3.0))
    close(tt.eq_vm_safe(torch.zeros(6, dtype=torch.float64), 2.0), jt.eq_vm_safe(jnp.zeros(6), 2.0))
    for name in ("I2", "I4", "J4", "K4", "MANDEL_BASIS", "T9_PERM", "I9"):
        np.testing.assert_array_equal(getattr(tt, name), np.asarray(getattr(jt, name)))
    close(tt.isotropic_C(70e3, 0.3), jt.isotropic_C(70e3, 0.3))


def test_eigh33_matches_jax():
    w, U = tt.eigh33(torch.as_tensor(SYM))
    w_j, _ = jt.eigh33(jnp.asarray(SYM))
    close(w, w_j)
    close(U @ torch.diag_embed(w) @ U.transpose(-1, -2), SYM)
    close(tt.eigvals33_smooth(torch.as_tensor(SYM)), w_j, rtol=1e-10)


def test_rotation_operators_rotate():
    """mandel(R A R^T) = Q6 mandel(A) and vec9(R A R^T) = Q9 vec9(A)."""
    R, A = torch.as_tensor(ROT), torch.as_tensor(M33)
    S = torch.as_tensor(SYM)
    rot = lambda T: R @ T @ R.transpose(-1, -2)  # noqa: E731
    close(torch.einsum("nab,nb->na", tt.rotation_to_mandel6(R), tt.mat_to_sym(S)), tt.mat_to_sym(rot(S)))
    close(torch.einsum("nab,nb->na", tt.rotation_to_9(R), tt.mat_to_nonsym(A)), tt.mat_to_nonsym(rot(A)))


# stress states for the derivative checks: generic, uniaxial (two equal
# eigenvalues), hydrostatic and zero (all equal): AD must stay finite there
SIGS = np.concatenate([
    300.0 * RNG.normal(size=(4, 6)),
    [[350.0, 0, 0, 0, 0, 0], [200.0, 200.0, 200.0, 0, 0, 0], [0.0] * 6],
])


def test_eigvals33_smooth_first_derivative_matches_jax():
    f_t = lambda s: tt.eigvals33_smooth(tt.sym_to_mat(s))  # noqa: E731
    f_j = lambda s: jt.eigvals33_smooth(jt.sym_to_mat(s))  # noqa: E731
    J_t = torch.func.vmap(torch.func.jacfwd(f_t))(torch.as_tensor(SIGS))
    J_j = jax.vmap(jax.jacfwd(f_j))(jnp.asarray(SIGS))
    assert bool(torch.isfinite(J_t).all())
    close(f_t(torch.as_tensor(SIGS)), f_j(jnp.asarray(SIGS)), rtol=1e-12)
    close(J_t, J_j, rtol=1e-10)


@pytest.mark.parametrize("a", [2.0, 6.0, 10.0])
def test_hosford_norm_value_and_first_derivative_match_jax(a):
    n_t, n_j = hosford_t(a, 1e-10), hosford_j(a, 1e-10)
    x_t, x_j = torch.as_tensor(SIGS), jnp.asarray(SIGS)
    close(torch.func.vmap(n_t)(x_t), jax.vmap(n_j)(x_j), rtol=1e-12)
    g_t = torch.func.vmap(torch.func.jacfwd(n_t))(x_t)
    g_j = jax.vmap(jax.jacfwd(n_j))(x_j)
    assert bool(torch.isfinite(g_t).all())
    close(g_t, g_j, rtol=1e-10)
    # reverse mode is what the return map's flow direction uses
    close(torch.func.vmap(torch.func.grad(n_t))(x_t), jax.vmap(jax.grad(n_j))(x_j), rtol=1e-10)


@pytest.mark.parametrize("name", ["rankine_norm", "l1_rankine_norm"])
def test_conic_norm_value_and_first_derivative_match_jax(name):
    n_t = getattr(conic_t, name)(smooth=1e-2, scale=350.0)
    n_j = getattr(conic_j, name)(smooth=1e-2, scale=350.0)
    x_t, x_j = torch.as_tensor(SIGS), jnp.asarray(SIGS)
    close(torch.func.vmap(n_t)(x_t), jax.vmap(n_j)(x_j), rtol=1e-12)
    g_t = torch.func.vmap(torch.func.jacfwd(n_t))(x_t)
    assert bool(torch.isfinite(g_t).all())
    close(g_t, jax.vmap(jax.jacfwd(n_j))(x_j), rtol=1e-10)
    close(torch.func.vmap(torch.func.grad(n_t))(x_t), jax.vmap(jax.grad(n_j))(x_j), rtol=1e-10)
