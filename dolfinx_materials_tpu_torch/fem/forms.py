"""Expression layer: per-quadrature-point kinematic expressions.

An expression is ``expr(ctx) -> (size,)`` with ``ctx.u (ncomp,)``,
``ctx.grad (ncomp, dim)`` and ``ctx.x (dim,)`` at one Gauss point, written in
torch; its variation for tangent assembly comes from ``torch.func``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

SQ2 = float(np.sqrt(2.0))


class Ctx(NamedTuple):
    u: torch.Tensor  # (ncomp,) field value at the point
    grad: torch.Tensor  # (ncomp, dim) field gradient
    x: torch.Tensor  # (dim,) physical coordinates


def mandel_strain_2d(plane="strain"):
    """2D displacement -> Mandel strain 6-vector [exx, eyy, 0, s2 exy, 0, 0]."""

    def expr(ctx):
        g = ctx.grad
        exy = 0.5 * (g[0, 1] + g[1, 0])
        z = torch.zeros_like(exy)
        return torch.stack([g[0, 0], g[1, 1], z, SQ2 * exy, z, z])

    return expr


def plane_stress_strain_3():
    """2D displacement -> plane-stress Mandel 3-vector [exx, eyy, s2 exy],
    work-conjugate to a 3-vector Stress."""

    def expr(ctx):
        g = ctx.grad
        return torch.stack([g[0, 0], g[1, 1], SQ2 * 0.5 * (g[0, 1] + g[1, 0])])

    return expr


def mandel_strain_3d():
    """3D displacement -> Mandel strain 6-vector."""

    def expr(ctx):
        g = ctx.grad
        return torch.stack(
            [
                g[0, 0],
                g[1, 1],
                g[2, 2],
                SQ2 * 0.5 * (g[0, 1] + g[1, 0]),
                SQ2 * 0.5 * (g[0, 2] + g[2, 0]),
                SQ2 * 0.5 * (g[1, 2] + g[2, 1]),
            ]
        )

    return expr


def axisymmetric_strain():
    """Axisymmetric (r, z) displacement (u_r, u_z) -> Mandel strain
    [e_rr, e_tt, e_zz, 0, s2 e_rz, 0] with the hoop strain u_r / r. With axes
    ordered (r, theta, z) the r-z shear lives in the 13-slot (Mandel index 4);
    principal-stress models and rotation operators rely on this placement.
    Pair with a QuadratureDomain ``weight=lambda x: 2*pi*x[:, 0]`` measure."""

    def expr(ctx):
        g = ctx.grad
        erz = 0.5 * (g[0, 1] + g[1, 0])
        z = torch.zeros_like(erz)
        return torch.stack([g[0, 0], ctx.u[0] / ctx.x[0], g[1, 1], z, SQ2 * erz, z])

    return expr


def scalar_value():
    """Scalar field -> (1,) value (external-state-variable expressions, e.g.
    the temperature itself in generalized behaviors)."""

    def expr(ctx):
        return ctx.u[:1]

    return expr
