"""Differentiable matrix functions of symmetric 3x3 tensors, from matrix
products only.

The finite-strain models need logm/expm/powm of (near-)SPD 3x3 tensors (Ogden
stretch powers, Hencky strains). Eigendecomposition AD produces NaN
derivatives at coincident eigenvalues, and the reference configuration F = I
is exactly that point. Every algorithm here is built from matrix products and
additions with fixed iteration counts, so it is differentiable everywhere,
repeated eigenvalues included, and needs no linear solve:

- ``sqrtm``: trace-prescaled coupled Newton-Schulz (also yields the inverse
  square root);
- ``logm``: inverse scaling-squaring (``roots`` Newton-Schulz roots, then a
  Gregory series whose (X+I)^{-1} comes from a Newton inverse iteration);
- ``expm``: scaling-squaring with a Taylor core;
- ``powm``: expm(a logm(X)).

About 1e-13 relative for SPD matrices with an eigenvalue condition up to
~1e4 (held against the JAX package in tests/test_torch_matfun.py).
"""

from __future__ import annotations

import torch


def _eye(X):
    return torch.eye(3, dtype=X.dtype, device=X.device).expand(X.shape)


def _tr(X):
    return X[..., 0, 0] + X[..., 1, 1] + X[..., 2, 2]


def sqrtm_ns(X, iters: int = 18):
    """Coupled Newton-Schulz: ``(sqrt(X), inv(sqrt(X)))`` for SPD X.

    Trace prescaling maps the spectrum into (0, 3], where the iteration
    converges; 18 iterations cover an eigenvalue spread up to ~1e4 in f64."""
    c = _tr(X) / 3.0
    c = torch.where(c <= 0, torch.ones_like(c), c)[..., None, None]
    A = X / c
    I = _eye(X)
    Y, Z = A, I
    for _ in range(iters):
        T = 0.5 * (3.0 * I - Z @ Y)
        Y = Y @ T
        Z = T @ Z
    s = torch.sqrt(c)
    return s * Y, Z / s


def sqrtm(X, iters: int = 18):
    """Principal square root of SPD ``(..., 3, 3)``."""
    return sqrtm_ns(X, iters)[0]


def _inv_near(A, X0, iters: int = 8):
    """Newton inverse iteration X <- X (2I - A X); quadratic from a fair X0."""
    I2 = 2.0 * _eye(A)
    X = X0
    for _ in range(iters):
        X = X @ (I2 - A @ X)
    return X


def inv_spd(X, iters: int = 18):
    """SPD inverse from matrix products: Newton-Schulz (inv(sqrt))^2."""
    _, Zi = sqrtm_ns(X, iters)
    return Zi @ Zi


def logm(X, roots: int = 5, series_terms: int = 10, ns_iters: int = 16):
    """Principal logarithm of SPD ``(..., 3, 3)`` by inverse scaling-squaring:
    X^(1/2^roots), then ``log(Xr) = 2 atanh(S)`` with ``S = (Xr - I)(Xr +
    I)^{-1}``, multiplied back by 2^roots. With 5 roots, eigenvalues in
    [1e-3, 1e3] map to [0.81, 1.24] and the series (|S| < 0.11) is below
    1e-16 after 5 odd terms; the inverse is a Newton iteration from I/2."""
    I = _eye(X)
    Xr = X
    for _ in range(roots):
        Xr = sqrtm(Xr, ns_iters)
    S = (Xr - I) @ _inv_near(Xr + I, 0.5 * I)
    S2 = S @ S
    acc = torch.zeros_like(X)
    term = S
    for k in range(series_terms):
        acc = acc + term / (2 * k + 1)
        term = term @ S2
    return (2.0 ** (roots + 1)) * acc


def expm(X, squarings: int = 12, series_terms: int = 14):
    """Matrix exponential of symmetric ``(..., 3, 3)`` by scaling-squaring and
    a Taylor core: 12 squarings handle ||X|| up to ~1e3 with 14 terms in f64."""
    A = X / 2.0**squarings
    I = _eye(X)
    acc = I
    term = I
    for k in range(1, series_terms + 1):
        term = term @ A / k
        acc = acc + term
    for _ in range(squarings):
        acc = acc @ acc
    return acc


def powm(X, a, roots: int = 5, **kw):
    """X^a for SPD X via expm(a logm(X)); ``a`` may be a tensor."""
    return expm(a * logm(X, roots=roots), **kw)


def tr_powm(X, a, roots: int = 5):
    """trace(X^a): the Ogden building block sum_i lambda_i^a, without eigh."""
    return _tr(powm(X, a, roots=roots))
