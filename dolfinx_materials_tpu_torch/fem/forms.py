"""Expression layer: per-quadrature-point kinematic expressions.

An expression is ``expr(ctx) -> (size,)`` with ``ctx.u (ncomp,)``,
``ctx.grad (ncomp, dim)`` and ``ctx.x (dim,)`` at one Gauss point, written in
torch; its variation for tangent assembly comes from ``torch.func``.

Every builder tags its expression with ``expr.kinematics``: "mandel" for the
Mandel strain vectors (their shear slots carry the float64 constant sqrt(2)
in the JAX package, which promotes a float32 evaluation to float64 there),
"deformation_gradient" and "scalar" for the rest. ``precision="mixed"``
(parallel/sharding.py) reads the tag through :func:`mixed_tangent_dtype`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

SQ2 = float(np.sqrt(2.0))


#: kinematics whose float32 evaluation the JAX package promotes to float64
F64_KINEMATICS = ("mandel",)


def _tagged(kinematics):
    def tag(builder):
        @functools.wraps(builder)
        def build(*args, **kwargs):
            expr = builder(*args, **kwargs)
            expr.kinematics = kinematics
            return expr

        return build

    return tag


def mixed_tangent_dtype(exprs):
    """The tangent and CG dtype of ``precision="mixed"`` for a problem whose
    registered gradients are ``exprs``: float64 if any is a Mandel-strain
    expression, else float32 (untagged user expressions count as float32)."""
    kinds = {getattr(e, "kinematics", None) for e in exprs}
    return torch.float64 if kinds & set(F64_KINEMATICS) else torch.float32


class Ctx(NamedTuple):
    u: torch.Tensor  # (ncomp,) field value at the point
    grad: torch.Tensor  # (ncomp, dim) field gradient
    x: torch.Tensor  # (dim,) physical coordinates


@_tagged("mandel")
def mandel_strain_2d(plane="strain"):
    """2D displacement -> Mandel strain 6-vector [exx, eyy, 0, s2 exy, 0, 0]."""

    def expr(ctx):
        g = ctx.grad
        exy = 0.5 * (g[0, 1] + g[1, 0])
        z = torch.zeros_like(exy)
        return torch.stack([g[0, 0], g[1, 1], z, SQ2 * exy, z, z])

    return expr


@_tagged("mandel")
def plane_stress_strain_3():
    """2D displacement -> plane-stress Mandel 3-vector [exx, eyy, s2 exy],
    work-conjugate to a 3-vector Stress."""

    def expr(ctx):
        g = ctx.grad
        return torch.stack([g[0, 0], g[1, 1], SQ2 * 0.5 * (g[0, 1] + g[1, 0])])

    return expr


@_tagged("mandel")
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


def mandel_strain(dim):
    return mandel_strain_2d() if dim == 2 else mandel_strain_3d()


@_tagged("deformation_gradient")
def deformation_gradient_2d():
    """2D displacement -> F = I + grad(u) as a 9-vector
    [11,22,33,12,21,13,31,23,32] with F33 = 1."""

    def expr(ctx):
        g = ctx.grad
        one = torch.ones_like(g[0, 0])
        z = torch.zeros_like(g[0, 0])
        return torch.stack([1 + g[0, 0], 1 + g[1, 1], one, g[0, 1], g[1, 0], z, z, z, z])

    return expr


@_tagged("deformation_gradient")
def deformation_gradient_3d():
    """3D displacement -> F = I + grad(u) as a 9-vector
    [11,22,33,12,21,13,31,23,32]."""

    def expr(ctx):
        g = ctx.grad
        return torch.stack([
            1 + g[0, 0], 1 + g[1, 1], 1 + g[2, 2],
            g[0, 1], g[1, 0], g[0, 2], g[2, 0], g[1, 2], g[2, 1],
        ])

    return expr


def deformation_gradient(dim):
    return deformation_gradient_2d() if dim == 2 else deformation_gradient_3d()


@_tagged("mandel")
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


@_tagged("scalar")
def scalar_gradient():
    """Scalar field -> its spatial gradient (dim,) (heat conduction)."""

    def expr(ctx):
        return ctx.grad[0]

    return expr


@_tagged("scalar")
def scalar_value():
    """Scalar field -> (1,) value (external-state-variable expressions, e.g.
    the temperature itself in generalized behaviors)."""

    def expr(ctx):
        return ctx.u[:1]

    return expr
