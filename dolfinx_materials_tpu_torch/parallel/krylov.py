"""Krylov building blocks of the fused load step.

Counterparts of dolfinx_materials_tpu/parallel/krylov.py: the preconditioned
BiCGStab of the blocked monolithic step (a plain loop with the stopping rule
and breakdown exits of the JAX one) and the SPD-preserving node-block inverse
of every block-Jacobi smoother.
"""

from __future__ import annotations

import torch


def _norm2(v):
    return torch.sqrt(torch.dot(v, v))


def _pbicgstab(Av, b, M, maxiter, tol, atol=0.0):
    """Left-preconditioned BiCGStab, x0 = 0: iterate while
    ``|r|^2 > max(tol |b|, atol)^2``, fewer than ``maxiter`` steps were taken
    and rho is not 0. A breakdown divisor (rho, omega or a denominator
    exactly 0) is replaced by the dtype's eps; the caller's non-finite guard
    handles the rest. One host read per iteration (the test)."""
    x = torch.zeros_like(b)
    r = b
    rhat, p, q = b, x, x
    bs = float(max(tol * float(_norm2(b)), atol)) ** 2
    eps = torch.finfo(b.dtype).eps
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    k = 0

    def safe(d):
        return torch.where(d == 0, torch.full_like(d, eps), d)

    while k < maxiter and float(torch.dot(r, r)) > bs and float(rho.abs()) > 0:
        rho_ = torch.dot(rhat, r)
        beta = (rho_ / safe(rho)) * (alpha / safe(omega))
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = Av(phat)
        alpha = rho_ / safe(torch.dot(rhat, q))
        s = r - alpha * q
        shat = M(s)
        t = Av(shat)
        omega = torch.dot(t, s) / safe(torch.dot(t, t))
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_
        k += 1
    return x


def _sym_block_inv(Bm, eye):
    """SPD-preserving inverse of the (n, ncomp, ncomp) node blocks of the
    Jacobi smoother: invert ``D^-1/2 B D^-1/2`` (its condition is set by the
    block's internal coupling, not its scale) symmetrised, then symmetrise
    and unscale the result. A plain inverse of near-incompressible f32
    tangent blocks loses symmetry and definiteness and breaks CG."""
    d = torch.diagonal(Bm, dim1=1, dim2=2).abs()
    s = 1.0 / torch.sqrt(torch.clamp(d, min=1e-30))
    Bs = Bm * s[:, :, None] * s[:, None, :]
    Bs = 0.5 * (Bs + Bs.transpose(1, 2))
    Binv = torch.linalg.inv(Bs)
    Binv = 0.5 * (Binv + Binv.transpose(1, 2))
    return Binv * s[:, :, None] * s[:, None, :]
