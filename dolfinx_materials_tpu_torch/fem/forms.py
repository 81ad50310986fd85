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
