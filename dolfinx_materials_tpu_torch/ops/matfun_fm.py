"""Feature-major batched 3x3 matrix functions: tensors shaped (3, 3, n).

The point axis is last, so every matrix operation is nine elementwise
operations on (n,) vectors. Same algorithms as ops/matfun.py (Newton-Schulz
square roots, inverse scaling-squaring log, scaling-squaring exp): products
and elementwise operations only, fixed iteration counts (Python loops of a
fixed count), differentiable at coincident eigenvalues.

The ``t_*`` functions work on a nested-tuple representation: a batched 3x3
matrix as a 3x3 tuple of (n,) tensors, with no stack or slice operations;
the Ogden energy (models/hyperelasticity.py) is written on it.
"""

from __future__ import annotations

import math

import torch


def bmm(A, B):
    """(3,3,n) @ (3,3,n) batched over the trailing axis, as 27 elementwise
    products of (n,) vectors."""
    return torch.stack([
        torch.stack([A[i, 0] * B[0, j] + A[i, 1] * B[1, j] + A[i, 2] * B[2, j] for j in range(3)])
        for i in range(3)
    ])


def transpose(A):
    return A.transpose(0, 1)


def eye_like(A):
    return torch.eye(3, dtype=A.dtype, device=A.device)[:, :, None].expand(3, 3, A.shape[-1])


def trace(A):
    return A[0, 0] + A[1, 1] + A[2, 2]


def det(A):
    return (
        A[0, 0] * (A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1])
        - A[0, 1] * (A[1, 0] * A[2, 2] - A[1, 2] * A[2, 0])
        + A[0, 2] * (A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0])
    )


#: nonsym 9-vector order: index s -> (row i_s, col j_s)
NONSYM_IJ = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 0), (0, 2), (2, 0), (1, 2), (2, 1))


def from_nonsym_rows(v):
    """(n, 9) nonsym vectors [11,22,33,12,21,13,31,23,32] -> (3,3,n)."""
    v = v.T
    return torch.stack([
        torch.stack([v[0], v[3], v[5]]),
        torch.stack([v[4], v[1], v[7]]),
        torch.stack([v[6], v[8], v[2]]),
    ])


def to_nonsym_rows(A):
    """(3,3,n) -> (n,9) nonsym vectors."""
    return torch.stack(
        [A[0, 0], A[1, 1], A[2, 2], A[0, 1], A[1, 0], A[0, 2], A[2, 0], A[1, 2], A[2, 1]], dim=-1)


def inv33(A):
    """Closed-form adjugate inverse of (3,3,n)."""
    c00 = A[1, 1] * A[2, 2] - A[1, 2] * A[2, 1]
    c01 = A[0, 2] * A[2, 1] - A[0, 1] * A[2, 2]
    c02 = A[0, 1] * A[1, 2] - A[0, 2] * A[1, 1]
    c10 = A[1, 2] * A[2, 0] - A[1, 0] * A[2, 2]
    c11 = A[0, 0] * A[2, 2] - A[0, 2] * A[2, 0]
    c12 = A[0, 2] * A[1, 0] - A[0, 0] * A[1, 2]
    c20 = A[1, 0] * A[2, 1] - A[1, 1] * A[2, 0]
    c21 = A[0, 1] * A[2, 0] - A[0, 0] * A[2, 1]
    c22 = A[0, 0] * A[1, 1] - A[0, 1] * A[1, 0]
    return torch.stack([
        torch.stack([c00, c01, c02]),
        torch.stack([c10, c11, c12]),
        torch.stack([c20, c21, c22]),
    ]) * (1.0 / det(A))


_SQ2 = 2.0**0.5


def from_sym_cols(v):
    """(6, n) Mandel columns [11,22,33,sq2*12,sq2*13,sq2*23] -> (3,3,n)."""
    d, e, f = v[3] / _SQ2, v[4] / _SQ2, v[5] / _SQ2
    return torch.stack([
        torch.stack([v[0], d, e]),
        torch.stack([d, v[1], f]),
        torch.stack([e, f, v[2]]),
    ])


def to_sym_cols(A):
    """(3,3,n), symmetrised -> (6, n) Mandel columns."""
    return torch.stack([
        A[0, 0],
        A[1, 1],
        A[2, 2],
        _SQ2 * 0.5 * (A[0, 1] + A[1, 0]),
        _SQ2 * 0.5 * (A[0, 2] + A[2, 0]),
        _SQ2 * 0.5 * (A[1, 2] + A[2, 1]),
    ])


# ------------------------------------------------- tuple representation
def t_from_nonsym_rows(v):
    """(n, 9) nonsym vectors -> nested-tuple matrix of (n,) components."""
    v = v.T
    return ((v[0], v[3], v[5]), (v[4], v[1], v[7]), (v[6], v[8], v[2]))


def t_transpose(A):
    return tuple(tuple(A[j][i] for j in range(3)) for i in range(3))


def t_bmm(A, B):
    return tuple(
        tuple(sum(A[i][k] * B[k][j] for k in range(3)) for j in range(3)) for i in range(3))


def t_add(A, B):
    return tuple(tuple(A[i][j] + B[i][j] for j in range(3)) for i in range(3))


def t_scale(s, A):
    return tuple(tuple(s * A[i][j] for j in range(3)) for i in range(3))


def t_trace(A):
    return A[0][0] + A[1][1] + A[2][2]


def t_eye_like(A):
    one = torch.ones_like(A[0][0])
    zero = torch.zeros_like(A[0][0])
    return ((one, zero, zero), (zero, one, zero), (zero, zero, one))


def t_det(A):
    return (
        A[0][0] * (A[1][1] * A[2][2] - A[1][2] * A[2][1])
        - A[0][1] * (A[1][0] * A[2][2] - A[1][2] * A[2][0])
        + A[0][2] * (A[1][0] * A[2][1] - A[1][1] * A[2][0])
    )


def t_inv33(A):
    c00 = A[1][1] * A[2][2] - A[1][2] * A[2][1]
    c01 = A[0][2] * A[2][1] - A[0][1] * A[2][2]
    c02 = A[0][1] * A[1][2] - A[0][2] * A[1][1]
    c10 = A[1][2] * A[2][0] - A[1][0] * A[2][2]
    c11 = A[0][0] * A[2][2] - A[0][2] * A[2][0]
    c12 = A[0][2] * A[1][0] - A[0][0] * A[1][2]
    c20 = A[1][0] * A[2][1] - A[1][1] * A[2][0]
    c21 = A[0][1] * A[2][0] - A[0][0] * A[2][1]
    c22 = A[0][0] * A[1][1] - A[0][1] * A[1][0]
    idet = 1.0 / (A[0][0] * c00 + A[0][1] * c10 + A[0][2] * c20)
    return (
        (c00 * idet, c01 * idet, c02 * idet),
        (c10 * idet, c11 * idet, c12 * idet),
        (c20 * idet, c21 * idet, c22 * idet),
    )


def _guards(dtype, eps, delta):
    """The smoothing and clamp guards, raised to a few ulps of ``dtype``: in
    f32, 1 - 1e-12 rounds to exactly 1.0, the clamp would do nothing and
    d(arccos)/dr = -1/sqrt(1 - r^2) would be inf at coincident eigenvalues."""
    feps = torch.finfo(dtype).eps
    return max(eps, 4.0 * feps), max(delta, 8.0 * feps)


def _cardano(q, B00, B11, B22, S01, S02, S12, S10, S20, S21, scale2, eps, delta):
    p2 = B00 * B00 + B11 * B11 + B22 * B22 + 2.0 * (S01**2 + S02**2 + S12**2)
    p = torch.sqrt(p2 / 6.0 + eps * eps * (scale2 + 1.0))
    detB = (
        B00 * (B11 * B22 - S12 * S21)
        - S01 * (S10 * B22 - S12 * S20)
        + S02 * (S10 * S21 - B11 * S20)
    )
    r = torch.clamp(detB / (2.0 * p**3), -1.0 + delta, 1.0 - delta)
    phi = torch.arccos(r) / 3.0
    lam1 = q + 2.0 * p * torch.cos(phi)
    lam3 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam2 = 3.0 * q - lam1 - lam3
    return lam3, lam2, lam1


def t_eigvals_sym(S, eps=1e-12, delta=1e-12):
    """Tuple twin of :func:`eigvals_sym` (Cardano, smooth-guarded)."""
    eps, delta = _guards(S[0][0].dtype, eps, delta)
    q = t_trace(S) / 3.0
    scale2 = sum(S[i][j] ** 2 for i in range(3) for j in range(3))
    return _cardano(q, S[0][0] - q, S[1][1] - q, S[2][2] - q, S[0][1], S[0][2], S[1][2], S[1][0], S[2][0],
                    S[2][1], scale2, eps, delta)


def eigvals_sym(S, eps=1e-12, delta=1e-12):
    """Closed-form (Cardano) eigenvalues of symmetric (3,3,n), ascending,
    smooth-guarded: ~50 elementwise operations, for isotropic invariant
    functions (Ogden stretch powers) that need no eigenvectors."""
    eps, delta = _guards(S.dtype, eps, delta)
    q = trace(S) / 3.0
    scale2 = sum(S[i, j] ** 2 for i in range(3) for j in range(3))
    return _cardano(q, S[0, 0] - q, S[1, 1] - q, S[2, 2] - q, S[0, 1], S[0, 2], S[1, 2], S[1, 0], S[2, 0],
                    S[2, 1], scale2, eps, delta)


def sqrtm_ns(X, iters: int = 18):
    """Coupled Newton-Schulz square root and inverse square root of SPD
    (3,3,n)."""
    c = trace(X) / 3.0
    c = torch.where(c <= 0, torch.ones_like(c), c)
    A = X / c
    I = eye_like(X)
    Y, Z = A, I
    for _ in range(iters):
        T = 0.5 * (3.0 * I - bmm(Z, Y))
        Y, Z = bmm(Y, T), bmm(T, Z)
    s = torch.sqrt(c)
    return s * Y, Z / s


def _inv_near(A, X0, iters: int = 8):
    I2 = 2.0 * eye_like(A)
    X = X0
    for _ in range(iters):
        X = bmm(X, I2 - bmm(A, X))
    return X


def logm(X, roots: int = 5, series_terms: int = 10, ns_iters: int = 16):
    I = eye_like(X)
    Xr = X
    for _ in range(roots):
        Xr = sqrtm_ns(Xr, ns_iters)[0]
    S = bmm(Xr - I, _inv_near(Xr + I, 0.5 * I))
    S2 = bmm(S, S)
    acc, term = torch.zeros_like(X), S
    for k in range(series_terms):
        acc = acc + term / float(2 * k + 1)
        term = bmm(term, S2)
    return (2.0 ** (roots + 1)) * acc


def logm_gregory(X, terms: int = 5):
    """Unrolled Gregory-series log of SPD (3,3,n) with spectrum near 1:
    ``log X = 2 sum_k S^(2k+1)/(2k+1)``, ``S = (X-I)(X+I)^{-1}`` with the
    closed-form inverse and no square roots. Per eigenvalue the truncation
    error is 2 s^(2T+1)/(2T+1), s = (lam-1)/(lam+1): T = 5 gives < 3e-7 for
    lam in [0.5, 2]. Arbitrary SPD spectra need :func:`logm`."""
    I = eye_like(X)
    S = bmm(X - I, inv33(X + I))
    S2 = bmm(S, S)
    term = acc = S
    for k in range(1, terms):
        term = bmm(term, S2)
        acc = acc + term / (2 * k + 1)
    return 2.0 * acc


def expm_unrolled(X, squarings: int = 3, terms: int = 8):
    """Unrolled scaling-squaring Taylor exp of symmetric (3,3,n) with small
    ||X|| (< 0.7 gives < 1e-12 with the defaults)."""
    A = X / 2.0**squarings
    I = eye_like(X)
    acc = term = I
    for k in range(1, terms + 1):
        term = bmm(term, A) / float(k)
        acc = acc + term
    for _ in range(squarings):
        acc = bmm(acc, acc)
    return acc


def expm(X, squarings: int = 12, series_terms: int = 14):
    A = X / 2.0**squarings
    I = eye_like(X)
    acc = term = I
    for k in range(1, series_terms + 1):
        term = bmm(term, A) / float(k)
        acc = acc + term
    for _ in range(squarings):
        acc = bmm(acc, acc)
    return acc
