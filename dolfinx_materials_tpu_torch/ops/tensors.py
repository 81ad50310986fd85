"""Mandel-convention tensor algebra (MFront ordering) on torch tensors.

Symmetric 2nd-order tensor -> 6-vector ``[T11, T22, T33, s2*T12, s2*T13,
s2*T23]`` with ``s2 = sqrt(2)``, so double contraction is a plain dot product
and 4th-order tensors on symmetric space are 6x6 matrices. Non-symmetric
2nd-order tensor -> 9-vector ``[T11, T22, T33, T12, T21, T13, T31, T23, T32]``.
The constants are numpy arrays; functions take tensors with any leading batch
axes, build their results with ``stack``/``cat`` (no in-place writes), and are
safe under ``torch.func`` transforms.
"""

import numpy as np
import torch

SQ2 = np.sqrt(2.0)

#: Second-order identity in Mandel 6-vector form.
I2 = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0])
#: Fourth-order symmetric identity in Mandel form (just the 6x6 identity).
I4 = np.eye(6)
#: Spherical projector J = (1/3) I2 (x) I2.
J4 = np.outer(I2, I2) / 3.0
#: Deviatoric projector K = I4 - J4.
K4 = I4 - J4

# 9-vector convention: vector position k -> (i, j) of the 3x3 tensor
_NS_IDX = np.array([(0, 0), (1, 1), (2, 2), (0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1)])
_NS_POS = np.zeros((3, 3), dtype=np.int64)
for _k, (_i, _j) in enumerate(_NS_IDX):
    _NS_POS[_i, _j] = _k
#: transpose permutation on the 9-vector: swaps (i,j) <-> (j,i)
T9_PERM = np.array([_NS_POS[j, i] for (i, j) in _NS_IDX])
#: Identity tensor as a 9-vector.
I9 = np.array([1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0])


def tr(v):
    """Trace of a Mandel 6-vector ``(..., 6)``."""
    return v[..., 0] + v[..., 1] + v[..., 2]


def dev(v):
    """Deviatoric part of a Mandel 6-vector ``(..., 6)``."""
    m = tr(v)[..., None] / 3.0
    return v - m * torch.as_tensor(I2, dtype=v.dtype, device=v.device)


def ddot(a, b):
    """Double contraction a:b of two Mandel 6-vectors — a plain dot product."""
    return torch.sum(a * b, dim=-1)


def norm(v):
    """Frobenius norm sqrt(v:v) of a Mandel 6-vector."""
    return torch.sqrt(ddot(v, v))


def pos(x):
    """Positive part as ``jnp.maximum(x, 0)``: slope 0.5 at 0, where a clamp
    passes 1 (forward-mode tangents differentiate through it)."""
    return torch.maximum(x, torch.zeros_like(x))


def eq_vm(sig):
    """Von Mises equivalent stress sqrt(3/2 s:s) of a Mandel stress 6-vector."""
    s = dev(sig)
    return torch.sqrt(1.5 * ddot(s, s))


def eq_vm_safe(sig, scale):
    """Von Mises stress sqrt(3/2 s:s) with a smooth guard at s = 0: adds
    ``(1e-14 * scale)^2`` under the root so the derivative stays finite at
    stress-free points (relative error < 1e-28)."""
    s = dev(sig)
    return torch.sqrt(1.5 * ddot(s, s) + (1e-14 * scale) ** 2)


def outer66(a, b):
    """Dyadic product of two 6-vectors -> (..., 6, 6) Mandel matrix."""
    return a[..., :, None] * b[..., None, :]


def sym_to_mat(v):
    """Mandel 6-vector ``(..., 6)`` -> symmetric 3x3 tensor ``(..., 3, 3)``."""
    a, b, c = v[..., 0], v[..., 1], v[..., 2]
    d = v[..., 3] / SQ2
    e = v[..., 4] / SQ2
    f = v[..., 5] / SQ2
    return torch.stack(
        [torch.stack([a, d, e], dim=-1), torch.stack([d, b, f], dim=-1), torch.stack([e, f, c], dim=-1)],
        dim=-2,
    )


def mat_to_sym(T):
    """3x3 tensor ``(..., 3, 3)`` -> Mandel 6-vector ``(..., 6)`` of its
    symmetric part."""
    S = 0.5 * (T + T.transpose(-1, -2))
    return torch.stack(
        [S[..., 0, 0], S[..., 1, 1], S[..., 2, 2],
         SQ2 * S[..., 0, 1], SQ2 * S[..., 0, 2], SQ2 * S[..., 1, 2]],
        dim=-1,
    )


def nonsym_to_mat(v):
    """9-vector ``(..., 9)`` -> full 3x3 tensor ``(..., 3, 3)``."""
    return torch.stack(
        [torch.stack([v[..., 0], v[..., 3], v[..., 5]], dim=-1),
         torch.stack([v[..., 4], v[..., 1], v[..., 7]], dim=-1),
         torch.stack([v[..., 6], v[..., 8], v[..., 2]], dim=-1)],
        dim=-2,
    )


def mat_to_nonsym(T):
    """Full 3x3 tensor ``(..., 3, 3)`` -> 9-vector ``(..., 9)``."""
    return torch.stack([T[..., int(i), int(j)] for (i, j) in _NS_IDX], dim=-1)


def transpose9(v):
    """Transpose acting on the 9-vector representation."""
    return torch.stack([v[..., int(k)] for k in T9_PERM], dim=-1)


def _mandel_basis():
    """Orthonormal basis E_a of symmetric 3x3 tensors matching the Mandel map."""
    E = np.zeros((6, 3, 3))
    for a, (i, j) in enumerate([(0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2)]):
        if i == j:
            E[a, i, j] = 1.0
        else:
            E[a, i, j] = E[a, j, i] = 1.0 / SQ2
    return E


MANDEL_BASIS = _mandel_basis()


def rotation_to_mandel6(R):
    """The 6x6 Mandel rotation operator Q with ``mandel(R A R^T) = Q @
    mandel(A)`` for symmetric A: ``Q_ab = <E_a, R E_b R^T>_F`` with the
    orthonormal Mandel basis ``E_a``. R: ``(..., 3, 3)`` rotation matrices."""
    E = torch.as_tensor(MANDEL_BASIS, dtype=R.dtype, device=R.device)
    return torch.einsum("aij,...ik,bkl,...jl->...ab", E, R, E, R)


def rotation_to_9(R):
    """The 9x9 operator Q9 with ``vec9(R A R^T) = Q9 @ vec9(A)`` for general A."""
    i, j = _NS_IDX[:, 0], _NS_IDX[:, 1]
    return R[..., i[:, None], i[None, :]] * R[..., j[:, None], j[None, :]]


def det33(T):
    """Determinant of ``(..., 3, 3)`` in closed form (no LU)."""
    return (
        T[..., 0, 0] * (T[..., 1, 1] * T[..., 2, 2] - T[..., 1, 2] * T[..., 2, 1])
        - T[..., 0, 1] * (T[..., 1, 0] * T[..., 2, 2] - T[..., 1, 2] * T[..., 2, 0])
        + T[..., 0, 2] * (T[..., 1, 0] * T[..., 2, 1] - T[..., 1, 1] * T[..., 2, 0])
    )


def inv33(T):
    """Closed-form inverse of ``(..., 3, 3)`` via the adjugate."""
    c00 = T[..., 1, 1] * T[..., 2, 2] - T[..., 1, 2] * T[..., 2, 1]
    c01 = T[..., 0, 2] * T[..., 2, 1] - T[..., 0, 1] * T[..., 2, 2]
    c02 = T[..., 0, 1] * T[..., 1, 2] - T[..., 0, 2] * T[..., 1, 1]
    c10 = T[..., 1, 2] * T[..., 2, 0] - T[..., 1, 0] * T[..., 2, 2]
    c11 = T[..., 0, 0] * T[..., 2, 2] - T[..., 0, 2] * T[..., 2, 0]
    c12 = T[..., 0, 2] * T[..., 1, 0] - T[..., 0, 0] * T[..., 1, 2]
    c20 = T[..., 1, 0] * T[..., 2, 1] - T[..., 1, 1] * T[..., 2, 0]
    c21 = T[..., 0, 1] * T[..., 2, 0] - T[..., 0, 0] * T[..., 2, 1]
    c22 = T[..., 0, 0] * T[..., 1, 1] - T[..., 0, 1] * T[..., 1, 0]
    adj = torch.stack(
        [torch.stack([c00, c01, c02], dim=-1),
         torch.stack([c10, c11, c12], dim=-1),
         torch.stack([c20, c21, c22], dim=-1)],
        dim=-2,
    )
    return adj / det33(T)[..., None, None]


def eigh33(S):
    """Eigendecomposition ``(eigenvalues ascending, eigenvectors)`` of
    symmetric ``(..., 3, 3)``: a thin wrapper of ``torch.linalg.eigh``."""
    return torch.linalg.eigh(S)


def eigvals33_smooth(S, eps=1e-12, delta=1e-12):
    """Closed-form (trigonometric) eigenvalues of symmetric ``(..., 3, 3)``,
    ascending, with smooth guards so AD stays finite at coincident
    eigenvalues (where ``eigvalsh``'s derivative is NaN): the derivative
    there is bounded and slightly inexact, O(sqrt(delta)) only near
    degeneracy. The guards are clamped to a few ulps of the dtype, since in
    f32 ``1 - 1e-12`` rounds to 1 and the arccos slope would be infinite."""
    feps = torch.finfo(S.dtype).eps
    eps = max(eps, 4.0 * feps)
    delta = max(delta, 8.0 * feps)

    q = (S[..., 0, 0] + S[..., 1, 1] + S[..., 2, 2]) / 3.0
    B = S - q[..., None, None] * torch.eye(3, dtype=S.dtype, device=S.device)
    p2 = torch.sum(B * B, dim=(-2, -1))
    scale2 = torch.sum(S * S, dim=(-2, -1))
    p = torch.sqrt(p2 / 6.0 + eps * eps * (scale2 + 1.0))
    Bn = B / p[..., None, None]
    r = torch.clamp(det33(Bn) / 2.0, -1.0 + delta, 1.0 - delta)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)  # largest
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * np.pi / 3.0)  # smallest
    lam2 = 3.0 * q - lam1 - lam3
    return torch.stack([lam3, lam2, lam1], dim=-1)


def isotropic_C(E, nu):
    """6x6 Mandel stiffness of isotropic linear elasticity (numpy float64):
    2*mu*I + lambda on the upper-left 3x3 block."""
    lmbda = E * nu / (1 + nu) / (1 - 2 * nu)
    mu = E / 2.0 / (1 + nu)
    C = 2 * mu * np.eye(6)
    C[:3, :3] += lmbda
    return C
